"""The example twins of the port (smoqyelphqmc_tpu_torch.examples) against
the JAX package's scripts of examples/: the same `run` signature plus
`device`, the same command line, and the same arguments to
`run_simulation` (data folder, every SimulationConfig field, the
measurement set, and the model, expanded from one NumPy seed in both
packages, exactly); then every twin's run on the CPU at
tests/test_examples.py's tiny sizes, with its full output set, the
checkpoint twin killed and resumed, and R_cdw from the in-memory bins."""

import ast
import dataclasses
import glob
import inspect
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_examples import h5_datasets, jax_script, tiny, twin

from smoqyelphqmc_tpu_torch.examples import TWINS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# the key tests/test_examples.py asserts in each script's metadata
KEY = {
    "holstein_honeycomb": "Rcdw_mean_real",
    "holstein_honeycomb_checkpoint": "hmc_acceptance_rate",
    "holstein_honeycomb_density_tuning": "final_mu",
    "holstein_honeycomb_multiwalker": "n_walkers",
}


class _Stop(Exception):
    pass


def _jax_call(name, monkeypatch):
    """Run the JAX script's `run` at its tiny keywords with everything after
    the set-up patched out; returns (sim_info, tbm, em, spec, cfg, extra)
    as the script built them (extra: the R_cdw call's keywords of
    holstein_honeycomb, W of the multiwalker script)."""
    mod = jax_script(name)
    got = {}
    if name == "holstein_honeycomb_multiwalker":
        # the script runs its own walker loop: take what it built up to the
        # expansion, then stop
        real_cfg = mod.SimulationConfig
        monkeypatch.setattr(mod, "initialize_datafolder", lambda info: got.__setitem__("info", info))
        monkeypatch.setattr(mod, "model_summary",
                            lambda info, beta, dtau, geo, tbm, ems: got.update(tbm=tbm, em=ems[0], geo=geo))

        def cfg(**kw):
            got["cfg"] = real_cfg(**kw)
            return got["cfg"]

        def stop(*a, **k):
            raise _Stop

        monkeypatch.setattr(mod, "SimulationConfig", cfg)
        monkeypatch.setattr(mod, "TightBindingParameters", types.SimpleNamespace(from_model=stop))
        kw = tiny(name)
        with pytest.raises(_Stop):
            mod.run(**kw)
        spec = mod.holstein_honeycomb_spec(got["geo"])  # the script's set, built from its geometry
        return got["info"], got["tbm"], got["em"], spec, got["cfg"], {"W": kw["n_walkers"]}

    def record(sim_info, tbm, em, spec, cfg, *args, **kw):
        got.update(args=(sim_info, tbm, em, spec, cfg), rest=(args, kw))
        return {}

    monkeypatch.setattr(mod, "run_simulation", record)
    if name == "holstein_honeycomb":
        monkeypatch.setattr(mod, "compute_composite_correlation_ratio",
                            lambda *a, **k: got.__setitem__("ratio", (a, k)) or (0j, 0.0))
        monkeypatch.setattr(mod, "save_simulation_info", lambda *a, **k: None)
    mod.run(**tiny(name))
    return (*got["args"], {"rest": got["rest"], "ratio": got.get("ratio")})


def _params(obj) -> dict:
    """A parameters dataclass's fields as NumPy values (None kept)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, (int, float, tuple)) else np.asarray(v)
    return out


def _assert_same_expansion(jtbm, jem, ptbm, pem, beta, dtau, seed):
    """Both packages' from_model of the two models, each from
    np.random.default_rng(seed): every field equal."""
    from smoqyelphqmc_tpu.models.electron_phonon import ElectronPhononParameters as JElph
    from smoqyelphqmc_tpu.models.tight_binding import TightBindingParameters as JTbp
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters as PElph
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters as PTbp

    jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
    jtbp = JTbp.from_model(jtbm, jr)
    ptbp = PTbp.from_model(ptbm, pr, device="cpu")
    jelph = JElph.from_model(beta, dtau, jem, jtbp, jr)
    pelph = PElph.from_model(beta, dtau, pem, ptbp, pr, device="cpu")
    for jp, pp in ((jtbp, ptbp), (jelph, pelph)):
        want = _params(jp)
        got = _params(pp)
        for k, v in got.items():
            assert k in want, k
            if v is None or want[k] is None:
                assert v is None and want[k] is None, k
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
            else:
                assert v == want[k], k


def _requests(spec):
    return ([(k, dataclasses.asdict(v)) for k, v in spec.correlations.items()],
            [(k, dataclasses.asdict(v)) for k, v in spec.composites.items()])


@pytest.mark.parametrize("name", TWINS)
def test_twin_passes_what_the_script_passes(name, monkeypatch):
    """The twin's `run` signature is the script's plus device="cuda", its
    `setup` the same without device, and `setup` builds what the script
    hands run_simulation: data folder prefix and sID, every SimulationConfig
    field the JAX config has, the measurement set, and the model, expanded
    in both packages from one seed, exactly."""
    jmod, pmod = jax_script(name), twin(name)
    jsig = list(inspect.signature(jmod.run).parameters.values())
    psig = list(inspect.signature(pmod.run).parameters.values())
    assert [(p.name, p.default) for p in psig] == [(p.name, p.default) for p in jsig] + [("device", "cuda")]
    assert [(p.name, p.default) for p in inspect.signature(pmod.setup).parameters.values()] == [
        (p.name, p.default) for p in jsig]

    jinfo, jtbm, jem, jspec, jcfg, extra = _jax_call(name, monkeypatch)
    pinfo, ptbm, pem, pspec, pcfg = pmod.setup(**tiny(name))
    assert (pinfo.datafolder_prefix, pinfo.sID, pinfo.pID) == (jinfo.datafolder_prefix, jinfo.sID, jinfo.pID)
    assert pinfo.filepath == jinfo.filepath
    if name == "holstein_honeycomb_multiwalker":
        # the JAX loop takes the sweep counts and W from run's arguments
        kw = tiny(name)
        loop = {k: kw[k] for k in ("N_therm", "N_measurements", "N_bins")}
        assert {k: getattr(pcfg, k) for k in loop} == loop and pcfg.n_walkers == extra["W"]
        skip = set(loop) | {"n_walkers"}
    else:
        rest = extra["rest"]
        assert rest == (((), {"resume": True}) if name == "holstein_honeycomb_checkpoint" else ((), {}))
        skip = set()
    for f in dataclasses.fields(jcfg):
        if f.name not in skip:
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert _requests(pspec) == _requests(jspec)
    assert pspec.geometry.n_sites == jspec.geometry.n_sites
    _assert_same_expansion(jtbm, jem, ptbm, pem, jcfg.beta, jcfg.dtau, jcfg.seed)
    if name == "holstein_honeycomb":
        args, kw = extra["ratio"]
        assert args[1:] == ("cdw",) and kw["q_point"] == (0, 0) and kw["spec"] is jspec
        assert kw["q_neighbors"] == pmod.cdw_neighbors(tiny(name)["L"])


# a value of each twin parameter, all different from one another, so that a
# keyword forwarded to the wrong parameter shows
DISTINCT = dict(sID=7, Omega=1.25, alpha=0.75, mu=0.125, n_target=0.875, flux=0.25, beta=0.5, N_therm=3,
                N_measurements=5, N_bins=2, checkpoint_freq_hours=0.5, runtime_limit_hours=2.5, n_walkers=3,
                dtau=0.0625, Nt=6, Nrv=4, tol=1e-9, maxiter=777, seed=11)


def _port_expansion(tbm, em, beta, dtau, seed) -> list:
    """The port's from_model of the two models from np.random.default_rng(seed)."""
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters

    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng, device="cpu")
    return [_params(tbp), _params(ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, device="cpu"))]


@pytest.mark.parametrize("name", TWINS)
def test_twin_run_forwards_its_arguments(name, tmp_path, monkeypatch):
    """run(...) hands run_simulation what setup(...) builds from the same
    keywords, each set to a value of its own, and passes device (and the
    checkpoint twin's resume=True) on."""
    pmod = twin(name)
    kw = {k: DISTINCT.get(k) for k in inspect.signature(pmod.setup).parameters}
    kw.update(L=tiny(name)["L"], filepath=str(tmp_path))
    got = {}

    def record(*args, **rest):
        got.update(args=args, rest=rest)
        return {}

    monkeypatch.setattr(pmod, "run_simulation", record)
    if name == "holstein_honeycomb":
        monkeypatch.setattr(pmod, "compute_composite_correlation_ratio", lambda *a, **k: (0j, 0.0))
        monkeypatch.setattr(pmod, "save_simulation_info", lambda *a, **k: None)
    pmod.run(**kw, device="cpu")
    want = pmod.setup(**kw)
    assert got["rest"] == ({"resume": True, "device": "cpu"} if name == "holstein_honeycomb_checkpoint"
                           else {"device": "cpu"})
    (info, tbm, em, spec, cfg), (winfo, wtbm, wem, wspec, wcfg) = got["args"], want
    assert dataclasses.asdict(info) == dataclasses.asdict(winfo)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(wcfg)
    assert _requests(spec) == _requests(wspec)
    for a, b in zip(_port_expansion(tbm, em, cfg.beta, cfg.dtau, 3), _port_expansion(wtbm, wem, cfg.beta, cfg.dtau, 3)):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[k], err_msg=k)
            else:
                assert v == b[k], k
    for k, v in kw.items():
        if k not in ("sID", "filepath", "Omega", "alpha", "mu", "L", "flux", "n_target"):
            assert getattr(cfg, k) == v, k
    assert (info.sID, info.filepath) == (kw["sID"], kw["filepath"])


def _jax_cli(name, argv):
    """The keywords the JAX script's __main__ block passes `run` for argv."""
    path = ROOT / "examples" / f"{name}.py"
    tree = ast.parse(path.read_text())
    block = next(n for n in tree.body if isinstance(n, ast.If) and "__main__" in ast.unparse(n.test))
    calls = []
    ns = {"sys": types.SimpleNamespace(argv=[str(path)] + argv), "run": lambda **kw: calls.append(kw)}
    exec(compile(ast.Module(body=block.body, type_ignores=[]), str(path), "exec"), ns)
    return calls[0]


@pytest.mark.parametrize("name", TWINS)
def test_twin_cli_maps_like_the_script(name, monkeypatch):
    """main(argv) of the twin calls run with the keywords the JAX script's
    command line gives (the multiwalker script's optional walker count with
    and without)."""
    pmod = twin(name)
    argvs = [["3", "2", "5", "7", "4", "6", "1", "8", "9", "10"]]
    if name == "holstein_honeycomb_multiwalker":
        argvs.append(argvs[0][:9])
    for argv in argvs:
        calls = []
        monkeypatch.setattr(pmod, "run", lambda **kw: calls.append(kw))
        pmod.main(argv)
        want = _jax_cli(name, argv)
        assert calls == [want]
        assert [type(v) for v in calls[0].values()] == [type(v) for v in want.values()]


def test_twins_import_runs_nothing(tmp_path):
    """Importing every twin (in a fresh process, from an empty directory)
    loads no jax, runs no simulation and writes nothing."""
    code = (
        "import importlib, sys\n"
        "from smoqyelphqmc_tpu_torch import driver\n"
        "def boom(*a, **k):\n"
        "    raise SystemExit('a twin ran the simulation at import')\n"
        "driver.run_simulation = driver.simulate = boom\n"
        "from smoqyelphqmc_tpu_torch.examples import TWINS\n"
        "for n in TWINS:\n"
        "    importlib.import_module('smoqyelphqmc_tpu_torch.examples.' + n)\n"
        "assert not {k.split('.')[0] for k in sys.modules} & {'jax', 'smoqyelphqmc_tpu'}\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok" and os.listdir(tmp_path) == []


def test_no_jax_walk_covers_the_twins():
    """The walk of test_port_imports_no_jax (tests/test_torch_models.py)
    reaches every twin."""
    import pkgutil

    import smoqyelphqmc_tpu_torch as p

    names = {m.name for m in pkgutil.walk_packages(p.__path__, "smoqyelphqmc_tpu_torch.")}
    assert {f"smoqyelphqmc_tpu_torch.examples.{n}" for n in TWINS} <= names


OUTPUT_SET = ("model_summary.toml", "simulation_info_pID-0.toml", "bins", "binned_data.h5", "stats.h5")


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_cpu(name, tmp_path):
    """run(**TINY, device="cpu") finishes with every solve converged, the
    key its JAX test asserts, and the full output set."""
    md = twin(name).run(**tiny(name, tmp_path), device="cpu")
    assert md["all_converged"] is True
    if name in KEY:
        assert np.isfinite(md[KEY[name]])
    if name == "holstein_honeycomb_multiwalker":
        assert md["n_walkers"] == 2
        assert len(glob.glob(str(tmp_path / "*" / "bins" / "bin-*_pID-1.h5"))) == 2
    (folder,) = glob.glob(str(tmp_path / "*"))
    for f in OUTPUT_SET:
        assert os.path.exists(os.path.join(folder, f)), f
    assert glob.glob(os.path.join(folder, "checkpoint*")) == []


def test_checkpoint_twin_resumes(tmp_path):
    """The checkpoint twin stopped by a runtime limit of 0 leaves a
    checkpoint and no merged bins; rerun, it resumes and writes the
    uninterrupted run's binned_data.h5 bit for bit."""
    pmod = twin("holstein_honeycomb_checkpoint")
    kw = tiny("holstein_honeycomb_checkpoint", tmp_path / "resumed", N_therm=2, N_measurements=4)
    pmod.run(**{**kw, "runtime_limit_hours": 0.0}, device="cpu")
    (folder,) = glob.glob(str(tmp_path / "resumed" / "*"))
    assert glob.glob(os.path.join(folder, "checkpoint*")) and not os.path.exists(os.path.join(folder, "binned_data.h5"))
    pmod.run(**kw, device="cpu")
    assert glob.glob(os.path.join(folder, "checkpoint*")) == []
    pmod.run(**tiny("holstein_honeycomb_checkpoint", tmp_path / "whole", N_therm=2, N_measurements=4), device="cpu")
    (whole,) = glob.glob(str(tmp_path / "whole" / "*"))
    got = h5_datasets(os.path.join(folder, "binned_data.h5"))
    ref = h5_datasets(os.path.join(whole, "binned_data.h5"))
    assert got.keys() == ref.keys() and ref
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["holstein_honeycomb", "holstein_honeycomb_multiwalker"])
def test_cdw_ratio_from_memory(name, tmp_path, monkeypatch):
    """R_cdw and its error from the bins as `simulate` yields them
    (composite_ratio_from_bins) equal those from binned_data.h5 and the JAX
    package's reader on the port's folder, to 1e-12."""
    from smoqyelphqmc_tpu.io import compute_composite_correlation_ratio as jax_ratio
    from smoqyelphqmc_tpu_torch.examples.holstein_honeycomb import cdw_neighbors
    from smoqyelphqmc_tpu_torch.io import measurements_io
    from smoqyelphqmc_tpu_torch.io.correlation_ratio import (
        composite_ratio_from_bins,
        compute_composite_correlation_ratio,
    )

    bins = {}
    write = measurements_io.write_measurement_bin

    def spy(info, b, tree, *args, **kw):
        bins[b if name == "holstein_honeycomb" else (info.pID, b)] = tree
        return write(info, b, tree, *args, **kw)

    monkeypatch.setattr(measurements_io, "write_measurement_bin", spy)
    pmod = twin(name)
    kw = tiny(name, tmp_path)
    md = pmod.run(**kw, device="cpu")
    sim_info, _, _, spec, cfg = pmod.setup(**kw)
    assert len(bins) == cfg.N_bins * cfg.n_walkers
    q = dict(q_point=(0, 0), q_neighbors=cdw_neighbors(kw["L"]))
    R, dR = composite_ratio_from_bins(bins, "cdw", spec, **q)
    Rf, dRf = compute_composite_correlation_ratio(sim_info.datafolder, "cdw", spec=spec, **q)
    Rj, dRj = jax_ratio(sim_info.datafolder, "cdw", spec=spec, **q)
    assert np.isfinite(R) and np.isfinite(dR) and dR > 0
    for r, d in ((Rf, dRf), (Rj, dRj)):
        assert abs(R - r) <= 1e-12 and abs(dR - d) <= 1e-12, (R, dR, r, d)
    if name == "holstein_honeycomb":
        assert (md["Rcdw_mean_real"], md["Rcdw_std"]) == (float(Rf.real), dRf)


def test_correlation_ratio_imports_without_h5py():
    """io/correlation_ratio.py imports where h5py cannot be imported, and
    computes a ratio from in-memory bins there."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "from smoqyelphqmc_tpu_torch.io import correlation_ratio as c\n"
        "from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model, holstein_honeycomb_spec\n"
        "spec = holstein_honeycomb_spec(holstein_honeycomb_model(3, 1.0, 0.5, 0.0)[0])\n"
        "rng = np.random.default_rng(0)\n"
        "pair = lambda: tuple(rng.standard_normal((4, 5, 3, 3)) for _ in range(2))\n"
        "bins = {b: {'composite': {'cdw': pair()}} for b in range(3)}\n"
        "R, dR = c.composite_ratio_from_bins(bins, 'cdw', spec, (0, 0), [(1, 0), (0, 1)])\n"
        "assert np.isfinite(R) and np.isfinite(dR)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
