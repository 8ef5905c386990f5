"""Weather-gated official-style bench capture.

A shared host's CPU allocation can swing several-fold within minutes:
a capture in a starved window wastes its
whole time budget recording weather. This tool measures the core share
a busy thread actually gets (thread_time/wall over a short spin); only
when the host is near full-core does it launch `python bench.py` and
append the resulting JSON line to CAPTURES_r4.log. Run from cron:

    python tools/weather_capture.py [--force]

Exit codes: 0 = capture ran, 3 = skipped (bad weather), >0 = error.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(REPO, "CAPTURES_r4.log")
STATE = os.path.join(REPO, ".weather_best.json")
THRESHOLD = float(os.environ.get("WEATHER_MIN_SHARE", "0.85"))
# fraction of the best-ever observed work rate required to capture:
# the host's EFFECTIVE core speed swings ~4x (process CPU seconds for
# identical work measured 5.2-6.3 s in good windows vs 22-26 s in bad
# ones), which a share probe cannot see — only a rate probe can
RATE_FRAC = float(os.environ.get("WEATHER_MIN_RATE_FRAC", "0.75"))


def core_share(seconds: float = 2.0) -> float:
    """Fraction of one core a busy thread gets right now."""
    t0w, t0c = time.perf_counter(), time.thread_time()
    x = 1.0
    while time.perf_counter() - t0w < seconds:
        for _ in range(10000):
            x = x * 1.0000001 + 1e-9
    return (time.thread_time() - t0c) / (time.perf_counter() - t0w)


def work_rate(seconds: float = 1.5) -> float:
    """Memory+ALU throughput proxy (arbitrary units/s): a fixed uint16
    multiply-clip-cast pass like the place kernel's, timed on wall."""
    import numpy as np
    t = (np.arange(4 << 20, dtype=np.uint16) * 3).astype(np.uint16)
    ff = np.full(t.shape, 1.01, np.float32)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        v = t * ff
        np.clip(v, 0, 65535, out=v)
        v.astype(np.uint16)
        n += 1
    return n / (time.perf_counter() - t0)


def best_rate(rate: float) -> float:
    """Roll the best observed rate through STATE, decaying 4%/hour.

    Without decay one freak fast window ratchets the bar so high that
    every later (perfectly usable) window reads as starved and the
    tool never captures again — observed: a 140/s best set at 05:50
    gated out a whole morning of 99-128/s windows. 4%/hour brings a
    stale best down to a typical window's level in ~8 h, i.e. within
    a round, while still preferring genuinely fast windows for hours."""
    now = time.time()
    best = rate
    try:
        d = json.load(open(STATE))
        age_h = max(0.0, now - float(d.get("ts", now))) / 3600.0
        best = max(best, float(d["rate"]) * 0.96 ** age_h)
    except (OSError, ValueError, KeyError):
        pass
    try:
        json.dump({"rate": best, "ts": now}, open(STATE, "w"))
    except OSError:
        pass
    return best


def main() -> int:
    share = core_share()
    rate = work_rate()
    best = best_rate(rate)
    try:
        load1 = open("/proc/loadavg").read().split()[0]
    except OSError:
        load1 = "?"
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
    head = (f"{stamp} share={share:.2f} rate={rate:.1f}/s "
            f"(best {best:.1f}) load1={load1}")
    if ((share < THRESHOLD or rate < RATE_FRAC * best)
            and "--force" not in sys.argv):
        with open(LOG, "a") as f:
            f.write(head + " SKIP (starved window)\n")
        print(head, "-> skip")
        return 3
    env = dict(os.environ)
    env.setdefault("BENCH_REPEATS", "8")
    env.setdefault("BENCH_TIME_BUDGET", "480")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=1200)
    dt = time.perf_counter() - t0
    result = ""
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{") and '"metric"' in line:
            result = line
            break
    # persist the per-rep bench log (stderr) so every capture line in
    # CAPTURES_r4.log is auditable (which reps ran, which window the
    # baseline got) — a bare best-of JSON can hide a weather-skewed
    # ratio (observed: baseline reps starved 4x while ours-best rode a
    # later calm window)
    logdir = os.path.join(REPO, ".capture_logs")
    os.makedirs(logdir, exist_ok=True)
    tag = stamp.replace(" ", "_").replace(":", "")
    try:
        with open(os.path.join(logdir, f"bench_{tag}.log"), "w") as f:
            f.write(proc.stderr or "")
            f.write("\n--- stdout ---\n")
            f.write(proc.stdout or "")
    except OSError:
        pass
    with open(LOG, "a") as f:
        f.write(f"{head} CAPTURE ({dt:.0f}s, rc={proc.returncode}): "
                f"{result or '(no JSON line)'}\n")
    print(head, "->", result or f"rc={proc.returncode}")
    if result:
        try:
            vs = json.loads(result).get("vs_baseline", 0)
            print(f"vs_baseline {vs}")
        except json.JSONDecodeError:
            pass
    return 0 if proc.returncode == 0 else proc.returncode


if __name__ == "__main__":
    sys.exit(main())
