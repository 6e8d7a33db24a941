"""The port's observability report against the JAX package's, on the same
float64 RunLog: 8 ticks of the JAX package's ClosedLoopRunner on
experiment1, carried across with ``convert``.

Both reports recompute the same closed-form quantities from the same logged
states (forward kinematics, bound envelopes, error projections, the
Jacobian's conditioning), so every npz array agrees to 1e-10.  Without
figures the port's report needs no matplotlib.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from boundmpc_tpu.observability import generate_report as jax_report
from boundmpc_tpu.runtime import ClosedLoopRunner as JaxRunner
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import convert, ocp as tocp
from boundmpc_tpu_torch.observability import generate_report
from torch_shared import one_core_env, read_files, shared, write_files
from torch_shared import one_core_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10
TICKS = 8
FIGURES = {"position_errors", "orientation_errors", "joints", "cartesian", "phi", "timing",
           "manipulability", "approx_error", "error_derivatives", "joint_dynamics"}

# generate_report with figures off where matplotlib cannot be imported; with
# figures on it must raise.
NO_MPL = r"""
import sys
sys.modules["matplotlib"] = None
from types import SimpleNamespace
import numpy as np
from boundmpc_tpu_torch import convert, ocp
from boundmpc_tpu_torch.observability import generate_report
src, outdir = sys.argv[1:3]
d = np.load(src)
log = convert.from_numpy("RunLog", {k[4:]: d[k] for k in d.files if k.startswith("log.")})
path = convert.from_numpy("PathData", {k[5:]: d[k] for k in d.files if k.startswith("path.")},
                          device="cpu")
runner = SimpleNamespace(path=path, cfg=ocp.OcpConfig(), phi_max=float(d["phi_max"]))
rep = generate_report(log, runner, outdir, tail="nompl", figures=False, device="cpu")
assert rep.figures == {} and rep.timing["t_comp_avg"] > 0
try:
    generate_report(log, runner, outdir, tail="fig", figures=True, device="cpu")
except ImportError:
    print(rep.npz_path)
else:
    raise SystemExit("figures rendered without matplotlib")
"""


def _reports(tmp):
    """Both reports of one JAX RunLog, the inputs of NO_MPL and the files."""
    r = JaxRunner(jscen.experiment1())
    log = r.run(max_ticks=TICKS)
    rep_j = jax_report(log, r, str(tmp / "jax"), tail="t")
    path_np = {k: np.asarray(v) for k, v in r.path._asdict().items()}
    runner = SimpleNamespace(path=convert.from_numpy("PathData", path_np, device="cpu"),
                             cfg=tocp.OcpConfig(), phi_max=r.phi_max)
    rep_t = generate_report(convert.from_numpy("RunLog", log.arrays()), runner,
                            str(tmp / "port"), tail="t", device="cpu")
    np.savez(tmp / "inputs.npz", phi_max=r.phi_max,
             **{f"log.{k}": v for k, v in log.arrays().items()},
             **{f"path.{k}": v for k, v in path_np.items()})
    return rep_j, rep_t, str(tmp), read_files(tmp)


def _moved(rep, old, new):
    """A report whose files under ``old`` now lie under ``new``."""
    def move(p):
        return str(new / Path(p).relative_to(old))
    return dataclasses.replace(rep, outdir=move(rep.outdir), npz_path=move(rep.npz_path),
                               figures={k: move(v) for k, v in rep.figures.items()})


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """``_reports``, built once per run; its files written in this worker."""
    rep_j, rep_t, built_in, files = shared(
        "test_torch_report.reports", lambda: _reports(tmp_path_factory.mktemp("report_build")))
    tmp = write_files(tmp_path_factory.mktemp("report"), files)
    return _moved(rep_j, built_in, tmp), _moved(rep_t, built_in, tmp), tmp


def _same_npz(a, b):
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        np.testing.assert_allclose(np.asarray(db[k], np.float64), np.asarray(da[k], np.float64),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_report_npz_matches_jax(reports):
    rep_j, rep_t, _ = reports
    _same_npz(rep_j.npz_path, rep_t.npz_path)
    data = np.load(rep_t.npz_path)
    for key in ("audit_e_p_par", "audit_e_r_par", "audit_p_ref", "bounds", "bound_corners",
                "bound_pl_proj_xy", "bound_pu_proj_zy", "manipulability", "condition_number",
                "ellipsoid_volume", "approx_error"):
        assert key in data.files, key
    assert len(data["manipulability"]) == TICKS


def test_report_figures_and_timing_match_jax(reports):
    rep_j, rep_t, _ = reports
    assert set(rep_t.figures) == set(rep_j.figures) == FIGURES
    for f in rep_t.figures.values():
        assert os.path.getsize(f) > 1000
    assert rep_t.timing == rep_j.timing and rep_t.timing["t_comp_avg"] > 0


def test_report_derivative_cross_check(reports):
    """The JAX package's regression oracle, on the port's export: the
    numerically differentiated e_p tracks the MPC's computed de_p."""
    data = np.load(reports[1].npz_path)
    dt = float(np.median(np.diff(data["t"])))
    err = np.abs(np.gradient(data["e_p"], dt, axis=0)[1:-1] - data["de_p"][1:-1])
    assert np.median(err) < 5e-3


def test_report_without_matplotlib(reports):
    _, rep_t, tmp = reports
    out = subprocess.run([sys.executable, "-c", NO_MPL, str(tmp / "inputs.npz"),
                          str(tmp / "nompl")], capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT), env=one_core_env())
    assert out.returncode == 0, out.stderr[-4000:]
    _same_npz(rep_t.npz_path, out.stdout.strip().splitlines()[-1])
