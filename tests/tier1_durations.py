"""Per-test timing of a pytest run, readable even when the run is cut.

As a plugin it appends one JSON line to ``$TIER1_LOG`` for each test that
starts, each test phase that ends (setup, call, teardown: seconds, outcome,
xdist worker) and each module- or session-scoped fixture set-up (seconds,
worker); the controlling process adds, every 10 s, the load average, the
count of live python processes and the CPU seconds their threads used, by
kind (each process's main thread, XLA's named pools, and the threads left
named "python": XLA's unnamed runtime threads, OpenBLAS's and OpenMP's
pools), and the "python"-named threads' seconds by where they ran: an
xdist worker's process or a process a worker's test started, each put
down to the test file the worker was running.  A run cut by ``timeout``
prints no ``--durations`` table, but its log holds every phase that
finished::

    TIER1_LOG=/tmp/t1.jsonl PYTHONPATH=tests PYTEST_ADDOPTS="-p tier1_durations" \\
        <the Tier-1 command>
    python tests/tier1_durations.py /tmp/t1.jsonl    # the table per test file

The table gives, per test file, the tests whose call ended and passed, the
summed seconds of every phase, the workers that built each module fixture
that took a second or more (with the seconds of each build) and the
longest test; then the tests in
flight when the log ends, when the last test of the port's files and of
the others ended, the load average's median and maximum, and the CPU
seconds by kind of thread.
"""
import collections
import json
import os
import sys
import threading
import time

import pytest

LOG = os.environ.get("TIER1_LOG", "tier1_durations.jsonl")
WORKER = os.environ.get("PYTEST_XDIST_WORKER", "main")
_controller = False  # an xdist controller, which replays its workers' events


def _write(rec):
    rec.update(t=time.time(), w=WORKER)
    with open(LOG, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _comm(path):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


_where = {}  # pid -> where (see _where_of)


def _where_of(pid):
    """"controller" (this process), "pid:<pid>" (a process this one started:
    an xdist worker, which logs its pid), "sub:<worker>" (a process a
    worker's test started: it inherits ``PYTEST_XDIST_WORKER``) or "other"."""
    if pid not in _where:
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(e.split(b"=", 1) for e in f.read().split(b"\0") if b"=" in e)
        except (OSError, ValueError, IndexError):
            return "other"
        worker = env.get(b"PYTEST_XDIST_WORKER")
        _where[pid] = ("controller" if int(pid) == os.getpid() else
                       f"pid:{pid}" if ppid == os.getpid() else
                       f"sub:{worker.decode()}" if worker else "other")
    return _where[pid]


def _thread_cpu():
    """{(pid, tid): (kind, CPU seconds, where)} of every thread of every
    python process; kind is "main" (the process's own thread), "xla"
    (XLA's named pools), or "unnamed" (threads that kept the name
    "python": XLA's unnamed runtime threads, OpenBLAS's and OpenMP's
    pools); where is the
    process's ``_where_of``."""
    out = {}
    for pid in (p for p in os.listdir("/proc") if p.isdigit()):
        if not _comm(f"/proc/{pid}/comm").startswith("python"):
            continue
        where = _where_of(pid)
        try:
            tids = os.listdir(f"/proc/{pid}/task")
        except OSError:
            continue
        for tid in tids:
            try:
                with open(f"/proc/{pid}/task/{tid}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            name = stat[stat.index("(") + 1:stat.rindex(")")]
            fields = stat[stat.rindex(")") + 2:].split()
            kind = "main" if tid == pid else "xla" if name.startswith("tf_") else \
                "unnamed" if name.startswith("python") else "other"
            out[pid, tid] = (kind, (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK"),
                             where)
    return out


def _sample_load():
    """Every 10 s: the load average, the python processes, and the CPU
    seconds their threads used since the last sample, by kind, and the
    "python"-named threads' seconds by where."""
    last = _thread_cpu()
    while True:
        time.sleep(10)
        now = _thread_cpu()
        cpu, unnamed = collections.Counter(), collections.Counter()
        for key, (kind, sec, where) in now.items():
            d = max(0.0, sec - last[key][1]) if key in last else sec
            cpu[kind] += d
            if kind == "unnamed":
                unnamed[where] += d
        last = now
        with open("/proc/loadavg") as f:
            load1 = float(f.read().split()[0])
        _write({"ev": "load", "load1": load1, "python": len({p for p, _ in now}),
                "cpu": dict(cpu), "unnamed": dict(unnamed)})


def pytest_configure(config):
    global _controller
    _controller = WORKER == "main" and bool(config.getoption("numprocesses", None))
    if WORKER == "main":
        threading.Thread(target=_sample_load, daemon=True).start()
    else:
        _write({"ev": "pid", "pid": os.getpid()})


def pytest_runtest_logstart(nodeid, location):
    if not _controller:
        _write({"ev": "start", "id": nodeid})


def pytest_runtest_logreport(report):
    if not _controller:
        _write({"ev": "rep", "id": report.nodeid, "when": report.when, "d": report.duration,
                "o": report.outcome})


@pytest.hookimpl(hookwrapper=True)
def pytest_fixture_setup(fixturedef, request):
    t0 = time.time()
    yield
    if fixturedef.scope in ("module", "session"):
        _write({"ev": "fix", "name": fixturedef.argname, "scope": fixturedef.scope,
                "base": fixturedef.baseid, "d": time.time() - t0})


def table(path):
    """The markdown table of a log (see the module)."""
    recs = [json.loads(line) for line in open(path)]
    t0 = min(r["t"] for r in recs)
    summed, n_passed, longest = collections.Counter(), collections.Counter(), {}
    per_test, fixtures = collections.Counter(), collections.defaultdict(list)
    started, finished = {}, set()
    for r in recs:
        if r["ev"] == "start":
            started[r["id"]] = r["t"]
        elif r["ev"] == "rep":
            f = r["id"].split("::")[0]
            summed[f] += r["d"]
            per_test[r["id"]] += r["d"]
            if r["when"] == "teardown":
                finished.add(r["id"])
            n_passed[f] += r["when"] == "call" and r["o"] == "passed"
        elif r["ev"] == "fix" and r["scope"] == "module":
            fixtures[r["base"]].append((r["name"], r["w"], r["d"]))
    for test, d in per_test.items():
        f = test.split("::")[0]
        if d >= longest.get(f, ("", -1))[1]:
            longest[f] = (test.split("::", 1)[1], d)
    end = max(r["t"] for r in recs)
    out = [f"log span {end - t0:.0f} s, passed {sum(n_passed.values())}", "",
           "| File | Passed | Summed s | Module fixtures: workers that built (s each) "
           "| Longest test (s) |", "|---|---|---|---|---|"]
    for f in sorted(summed, key=lambda f: -summed[f]):
        builds = collections.defaultdict(list)
        for name, w, d in fixtures.get(f, []):
            builds[name].append((w, d))
        builds = {k: b for k, b in builds.items() if max(d for _, d in b) >= 1.0}
        fx = "; ".join(f"`{name}` {len({w for w, _ in b})} "
                       f"({', '.join(f'{d:.1f}' for _, d in b)})"
                       for name, b in builds.items()) or "-"
        name, d = longest[f]
        out.append(f"| `{os.path.basename(f)[:-3]}` | {n_passed[f]} | {summed[f]:.1f} | {fx} "
                   f"| `{name}` {d:.1f} |")
    flight = sorted(((end - t, test) for test, t in started.items() if test not in finished),
                    reverse=True)
    out += ["", "in flight at the end: " + ", ".join(f"`{t}` {s:.0f} s" for s, t in flight)]
    ends = collections.Counter()
    for r in recs:
        if r["ev"] == "rep" and r["when"] == "teardown":
            k = "port" if os.path.basename(r["id"].split("::")[0]).startswith("test_torch_") \
                else "others"
            ends[k] = max(ends[k], r["t"] - t0)
    out.append("last test ended, s after the log's first record: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(ends.items())))
    loads = sorted(r["load1"] for r in recs if r["ev"] == "load")
    if loads:
        out.append(f"load average (1 min): median {loads[len(loads) // 2]:.1f}, "
                   f"max {loads[-1]:.1f}")
        cpu = collections.Counter()
        for r in recs:
            cpu.update(r.get("cpu", {}))
        total = sum(cpu.values()) or 1.0
        out.append("CPU seconds of python threads: " + ", ".join(
            f"{k} {v:.0f} ({v / total:.0%})" for k, v in cpu.most_common()))
        out += _unnamed_lines(recs)
    return "\n".join(out)


def _unnamed_lines(recs):
    """The "python"-named threads' CPU seconds by where they ran: in the
    workers' own processes or in processes their tests started, each put
    down to the test file that worker was running at the sample."""
    worker_of = {f"pid:{r['pid']}": r["w"] for r in recs if r["ev"] == "pid"}
    running, by_where, by_file = {}, collections.Counter(), collections.Counter()
    for r in sorted(recs, key=lambda r: r["t"]):
        if r["ev"] == "start":
            running[r["w"]] = os.path.basename(r["id"].split("::")[0])[:-3]
        for where, sec in r.get("unnamed", {}).items():
            if where in worker_of:
                where, w = "worker", worker_of[where]
            elif where.startswith("sub:"):
                where, w = "subprocess", where[4:]
            else:
                by_where[where] += sec
                continue
            by_where[where] += sec
            by_file[where, running.get(w, "-")] += sec
    if not by_where:
        return []
    total = sum(by_where.values()) or 1.0
    return ["CPU seconds of \"python\"-named threads: " + ", ".join(
        f"{k} {v:.0f} ({v / total:.0%})" for k, v in by_where.most_common()),
        "  by the test file running: " + ", ".join(
            f"{w} `{f}` {v:.0f}" for (w, f), v in by_file.most_common(12))]


if __name__ == "__main__":
    print(table(sys.argv[1]))
