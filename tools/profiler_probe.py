"""How many device records torch.profiler keeps as a process ages, on a card.

Every ``--every`` seconds (spent in float32 matmuls, outside the profiler)
it profiles ``--windows`` windows of 10 one-kernel calls and prints each
window's device records (10 when none was lost); after ``--age`` seconds it
times a one-kernel and a two-kernel call through ``chip_smoke.device_ms``
``--repeats`` times each, with the device time and operations per call it
gives.  Needs a CUDA card:

    python3 tools/profiler_probe.py --age 200
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--age", type=float, default=200.0)
    ap.add_argument("--every", type=float, default=8.0)
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as c

    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: no CUDA card")
    x = torch.zeros(1 << 20, device="cuda")
    a = torch.randn(8192, 8192, device="cuda")
    one = lambda: x.add_(1)
    two = lambda: (x.add_(1), x.mul_(1))

    def window(fn, n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    print(c.smi_line(), flush=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.age:
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < args.every:
            for _ in range(50):
                a @ a
            torch.cuda.synchronize()
        row = [window(one, 10) for _ in range(args.windows)]
        print(f"t={time.perf_counter() - t0:.1f} s: records of "
              f"{args.windows} windows of 10 calls {row}", flush=True)
    for fn, name in ((one, "one kernel"), (two, "two kernels")):
        for _ in range(args.repeats):
            try:
                t, ops = c.device_ms(torch, fn, 10)
                print(f"device_ms, {name}: {t:.5f} ms, {ops} operations "
                      f"per call", flush=True)
            except RuntimeError as e:
                print(f"device_ms, {name}: failed: {e}", flush=True)
    print(f"t={time.perf_counter() - t0:.1f} s: records of {args.windows} "
          f"windows of 10 calls "
          f"{[window(one, 10) for _ in range(args.windows)]}", flush=True)


if __name__ == "__main__":
    main()
