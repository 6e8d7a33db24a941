"""The JAX package's side of a lane replay: the soak's fleet from a dumped
EngineState, at the window's shapes, on the CPU in float32 (the settings of
``experiments/soak.py``: ``RUNTIME_F32``, float64 off; ``--f64`` runs the
same in float64 from the dump cast up).

    python tests/jax_window_replay.py --state DUMP.npz --t0 20 --ticks 20 \\
        --live 65,232,0,1 --out jax.json [--order reverse] [--drop-lane 5]

Every lane outside ``--live`` is marked dead (a dead lane skips its solve, so
the live lanes keep the batch's shapes), the chunk runs through
``stream.make_stream_ticks``, and the live lanes' per-tick records go to
``--out`` in the layout of ``boundmpc_tpu_torch.experiments.replay_window``
(variant "jax").  ``--batch crossing`` takes the dry run's crossing batch
instead of the soak's fleet.  ``--order reverse`` and ``--drop-lane`` change nothing but
the batch's layout, a yardstick of the JAX package's own float32 noise (in
chunk 0 of the window they changed no bit).  The commit cohort is B, one commit phase per tick, which changes no
lane's numerics; B is the dump's (256 from rest).  ``--as-soak`` runs the
soak's own program instead (its cohort, and the compilation cache
``experiments/soak.py`` enables).  ``--pairs L:T,...`` runs lane L alone for
one tick from each dump ``--state.format(t=T)`` (one compile;
``--states-out`` keeps each result for
``boundmpc_tpu_torch.experiments.census maps``).

XLA's CPU thread pool spins: several of these processes, or one beside the
JAX soak, slow each other down by an order of magnitude.  Run each alone on
its own core (``XLA_FLAGS=--xla_cpu_multi_thread_eigen=false taskset -c N``):
a chunk of 20 ticks at B = 256 then takes 9-17 minutes, a one-tick pair
under a second.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="rest")
    ap.add_argument("--t0", type=int, default=0)
    ap.add_argument("--batch", default="soak", choices=["soak", "crossing"],
                    help="the soak's fleet, or the dry run's crossing batch "
                         "(__graft_entry__._build_crossing_batch)")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--live", default=None)
    ap.add_argument("--order", default="identity", choices=["identity", "reverse"])
    ap.add_argument("--f64", action="store_true",
                    help="float64 (x64 on), the dumped float32 state cast up, as "
                         "replay_window's cpu-f64 variant")
    ap.add_argument("--drop-lane", type=int, default=None)
    ap.add_argument("--subset", action="store_true")
    ap.add_argument("--as-soak", action="store_true",
                    help="the soak's program: its cohort, max(1, B // 16), and the JAX "
                         "package's compilation cache, as experiments/soak.py enables it")
    ap.add_argument("--states-out", default=None,
                    help="directory: the EngineState after the run, as state_t{t0 + ticks}.npz")
    ap.add_argument("--pairs", default=None,
                    help="L:T,... — lane L alone (B = 1) for one tick from the dump "
                         "--state.format(t=T) of each pair (one compile); all runs to --out")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.as_soak:
        from boundmpc_tpu.runtime import enable_compilation_cache
        enable_compilation_cache()
    if args.pairs:
        recs = []
        for pair in args.pairs.split(","):
            lane, t = (int(v) for v in pair.split(":"))
            recs.append(run_one(argparse.Namespace(**{
                **vars(args), "state": args.state.format(t=t), "t0": t, "ticks": 1,
                "live": str(lane), "subset": True, "out": None})))
        with open(args.out, "w") as fh:
            json.dump({"state": args.state, "pairs": args.pairs, "runs": recs}, fh)
    else:
        run_one(args)


_RUNS = {}


def run_one(args):

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from boundmpc_tpu import batch, engine, ocp, solver, stream
    from __graft_entry__ import _build_batch, _build_crossing_batch

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32
    cfg = ocp.OcpConfig()
    dump = None if args.state == "rest" else np.load(args.state)
    B = 256 if dump is None else dump["s0"].shape[0]
    build = _build_crossing_batch if args.batch == "crossing" else _build_batch
    states, paths, weights, x_phi_d = build(B, cfg, dtype=dtype)
    if dump is not None:
        states = jax.tree.map(lambda t, x: jnp.asarray(x, t.dtype), states,
                              engine.load_state_dump(states, dump))
    full = [np.array(leaf) for leaf in jax.tree.leaves(states)]  # for --states-out
    if args.live:
        live = np.zeros(B, bool)
        live[[int(x) for x in args.live.split(",")]] = True
        states = states._replace(dead=states.dead | jnp.asarray(~live))
    order = np.arange(B)
    if args.order == "reverse":
        order = order[::-1].copy()
    if args.drop_lane is not None:
        if not bool(states.dead[args.drop_lane]):
            raise SystemExit(f"--drop-lane {args.drop_lane} is a live lane")
        order = order[order != args.drop_lane]
    if args.subset:
        order = order[~np.asarray(states.dead)[order]]
    take = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[order]), tree)  # noqa
    states, paths, weights, x_phi_d = (take(x) for x in (states, paths, weights, x_phi_d))
    B = len(order)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    # cohort B: one commit phase per tick; the soak's own cohort under --as-soak
    key = (args.ticks, None if args.as_soak else B)
    if key not in _RUNS:
        _RUNS[key] = stream.make_stream_ticks(cfg, solver.RUNTIME_F32, args.ticks, dtype=dtype,
                                              donate=False, cohort=key[1])
    run = _RUNS[key]
    t0 = time.perf_counter()
    states, out = run(states, paths, weights, x_phi_d, pref)
    jax.block_until_ready(states.phi)
    seconds = time.perf_counter() - t0
    if args.states_out:
        os.makedirs(args.states_out, exist_ok=True)
        for f, leaf in zip(full, jax.tree.leaves(states)):
            f[order] = np.asarray(leaf)
        np.savez_compressed(os.path.join(args.states_out, f"jax_state_t{args.t0 + args.ticks}.npz"),
                            **{f"s{i}": f for i, f in enumerate(full)})

    succ, viol, iters, dead, errc = (np.asarray(x) for x in (
        out.success, out.viol, out.iters, out.dead, out.error_count))
    pos = {int(ln): i for i, ln in enumerate(order)}
    dead_in = dead[0] & (iters[0] == 0)
    lanes = [ln for ln in sorted(pos) if not dead_in[pos[ln]]]
    cols = [pos[ln] for ln in lanes]
    live_t = ~np.concatenate([np.zeros_like(dead[:1]), dead[:-1]], axis=0)
    failing = [{"lane": ln, "tick": args.t0 + t, "viol": float(viol[t, c]),
                "iters": int(iters[t, c]), "error_count": int(errc[t, c]), "exit": "-"}
               for ln, c in zip(lanes, cols) for t in range(succ.shape[0])
               if live_t[t, c] and not succ[t, c]]
    rec = {"variant": "jax", "device": "cpu", "dtype": "float64" if args.f64 else "float32", "B": B, "order": args.order,
           "t0": args.t0, "ticks": int(succ.shape[0]), "lanes": lanes,
           "success": succ[:, cols].tolist(), "viol": viol[:, cols].astype(float).tolist(),
           "iters": iters[:, cols].astype(int).tolist(),
           "error_count": errc[:, cols].astype(int).tolist(),
           "exit": [["-"] * len(cols)] * int(succ.shape[0]),
           "n_loop": int(out.n_loop), "seconds": seconds, "failing": failing}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"state": args.state, "live": args.live, "drop_lane": args.drop_lane,
                       "runs": [rec]}, fh)
    print(f"jax replay B={B} ticks {args.t0}-{args.t0 + args.ticks - 1}: {int(out.n_loop)} loop "
          f"iterations in {seconds:.1f} s; failing lane-ticks "
          + (", ".join(f"{f['lane']}@{f['tick']} ({f['viol']:.3g})" for f in failing) or "none"),
          file=sys.stderr, flush=True)
    return rec


if __name__ == "__main__":
    main()
