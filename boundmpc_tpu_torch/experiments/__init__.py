"""Command-line entry points (ports of ``experiments/run_experiment.py``,
``run_fleet.py`` and ``soak.py``), and the ports of the JAX package's
profiling and diagnostic probes (``profile_tick``, ``profile_solver``,
``prof_*``, ``dump_stragglers``, ``trace_solve``, ``debug_solve``,
``debug_f32``, ``replay_lane``, ``sweep_knobs``, ``dryrun_multichip``; what
they share is in ``probe``).

    python -m boundmpc_tpu_torch.experiments.run_experiment --name experiment1
    python -m boundmpc_tpu_torch.experiments.run_fleet --batch 256 --ticks 100
    python -m boundmpc_tpu_torch.experiments.soak --B 256 --ticks 120 --chunk 20

Each runs on the card unless the caller asks for the CPU (``--cpu``, or
``--platform cpu`` for the soak); without a card it exits nonzero.  Flags,
the stdout lines and the exit codes are the JAX scripts'.  Each module's
``run(args, device, dtype)`` does the run for parsed arguments and returns
the summary it prints.  One stderr line per run, which the JAX scripts do
not print, gives the GN loop iterations and the kernel launches.
"""
from __future__ import annotations

import argparse
import sys

import torch



def device_for(ap: argparse.ArgumentParser, cpu: bool, flag: str) -> str:
    """"cpu" when the caller asked for it, else "cuda"; without a card the
    parser exits (code 2) with a message that names ``flag``."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        ap.error(f"no CUDA device: this command runs on the card; pass {flag} to run it "
                 "on the CPU")
    return "cuda"


def log_launches(name: str, n_loop: int, n_launch: int) -> None:
    """The port's accounting line: GN loop iterations against kernel
    launches (0 on the CPU, where ``ls_solve`` runs its plain version)."""
    print(f"{name}: {n_loop} loop iterations, {n_launch} kernel launches", file=sys.stderr,
          flush=True)
