"""Per cent of the trajectory force evaluations of the window's run
(thermalization and measured sweeps) that took the plain derivative chain:
`simulate`'s `force_routes` at the runtime limit's stop, its 'plain' count
over the sum of its 'k3', 'k4' and 'plain' counts (one evaluation a walker a
kick). None where the program does not count its routes."""


def read(run):
    routes = run.metadata.get("force_routes")
    if not routes or not sum(routes.values()):
        return None
    return 100.0 * routes["plain"] / sum(routes.values())
