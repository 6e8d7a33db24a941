"""Which thread pool holds a command's CPU: each thread's CPU seconds put
down to the library its stack names.

Runs the command and, every half second, reads the CPU seconds of every
thread of its process tree.  When a thread sits in a system call, the
words of its stack (from ``/proc/<pid>/task/<tid>/syscall``'s stack
pointer up, through ``/proc/<pid>/mem``) that point into a mapped library
give its call chain; the outermost library other than libc and the loader
is where the thread started, which names its pool (``libjax_common.so``
for XLA's threads, ``libgomp`` for OpenMP's, ``libscipy_openblas`` for
OpenBLAS's).  The table sums CPU seconds by thread name and by the
innermost and outermost library seen::

    python tests/thread_pools.py python -m pytest tests/test_stream.py -q -p no:randomly

A thread never seen in a system call counts as "unseen".  Reading another
process's stack needs the right to trace it; the command's own tree is the
caller's.
"""
import collections
import os
import subprocess
import sys
import time

SKIP = ("libc.so", "ld-linux", "libpthread")


def _maps(pid):
    """(code mappings as (lo, hi, library), writable mappings as (lo, hi))."""
    code, data = [], []
    with open(f"/proc/{pid}/maps") as f:
        for line in f:
            fields = line.split()
            lo, hi = (int(x, 16) for x in fields[0].split("-"))
            if "x" in fields[1] and len(fields) > 5:
                code.append((lo, hi, os.path.basename(fields[5])))
            elif "rw" in fields[1]:
                data.append((lo, hi))
    return code, data


def _chain(pid, tid, code, data):
    """"innermost <- outermost" library on a thread's stack, or None when
    the thread is not in a system call or its stack cannot be read."""
    try:
        with open(f"/proc/{pid}/task/{tid}/syscall") as f:
            sc = f.read().split()
    except OSError:
        return None
    if len(sc) < 3 or sc[0] in ("running", "-1"):
        return None
    sp = int(sc[-2], 16)
    region = next(((lo, hi) for lo, hi in data if lo <= sp < hi), None)
    if region is None:
        return None
    try:
        with open(f"/proc/{pid}/mem", "rb") as m:
            m.seek(sp)
            buf = m.read(min(region[1] - sp, 1 << 20))
    except OSError:
        return None
    libs = []
    for i in range(0, len(buf) - 7, 8):
        a = int.from_bytes(buf[i:i + 8], "little")
        name = next((n for lo, hi, n in code if lo <= a < hi), None)
        if name and not name.startswith(SKIP) and (not libs or libs[-1] != name):
            libs.append(name)
    return f"{libs[0]} <- {libs[-1]}" if libs else None


def _tree(root):
    kids = collections.defaultdict(list)
    for p in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{p}/stat") as f:
                kids[int(f.read().rsplit(")", 1)[1].split()[1])].append(int(p))
        except (OSError, IndexError, ValueError):
            continue
    out, todo = [], [root]
    while todo:
        p = todo.pop()
        out.append(p)
        todo += kids[p]
    return out


def main(argv):
    t0 = time.time()
    proc = subprocess.Popen(argv)
    tick = os.sysconf("SC_CLK_TCK")
    seen, chain, name, cpu = {}, {}, {}, collections.Counter()
    while proc.poll() is None:
        time.sleep(0.5)
        for pid in _tree(proc.pid):
            try:
                code, data = _maps(pid)
                tids = os.listdir(f"/proc/{pid}/task")
            except OSError:
                continue
            for tid in tids:
                try:
                    with open(f"/proc/{pid}/task/{tid}/stat") as f:
                        stat = f.read()
                except OSError:
                    continue
                fields = stat[stat.rindex(")") + 2:].split()
                sec = (int(fields[11]) + int(fields[12])) / tick
                key = pid, int(tid)
                d = sec - seen.get(key, 0.0)
                seen[key] = sec
                comm = stat[stat.index("(") + 1:stat.rindex(")")]
                name[key] = "main" if int(tid) == pid else comm
                if d > 0 or key not in chain:
                    chain[key] = _chain(pid, tid, code, data) or chain.get(key)
                cpu[key] += d
    by, threads = collections.Counter(), collections.Counter()
    for key, sec in cpu.items():
        k = name[key], chain.get(key) or "unseen"
        by[k] += sec
        threads[k] += 1
    total = sum(by.values()) or 1.0
    print(f"rc {proc.returncode}, {time.time() - t0:.1f} s wall, {total:.1f} CPU s")
    for (n, c), sec in by.most_common(20):
        print(f"{sec:8.1f} s {sec / total:6.1%}  {threads[n, c]:3d} threads  {n:14s} {c}")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
