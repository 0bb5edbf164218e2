"""One process of the multiwalker twin run as a fleet, for
tests/test_torch_examples_fleet.py.

    python _torch_examples_fleet_worker.py <rank> <json keywords of run>

Runs smoqyelphqmc_tpu_torch.examples.holstein_honeycomb_multiwalker's
`run(**keywords, device="cpu")` with one torch thread. With WORLD_SIZE > 1,
MASTER_ADDR and MASTER_PORT in the environment, the worker adds RANK and
LOCAL_RANK (torchrun's environment) and the twin joins the fleet itself;
without them, it is one process. Prints the metadata's n_walkers and
all_converged and the fleet's size as JSON.
"""

import json
import os
import sys


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = sys.argv[1]

    import torch

    torch.set_num_threads(1)
    from smoqyelphqmc_tpu_torch.examples import holstein_honeycomb_multiwalker
    from smoqyelphqmc_tpu_torch.parallel.distributed import process_count

    md = holstein_honeycomb_multiwalker.run(**json.loads(sys.argv[2]), device="cpu")
    print(json.dumps({"n_walkers": md["n_walkers"], "all_converged": md["all_converged"],
                      "processes": process_count()}))


if __name__ == "__main__":
    main()
