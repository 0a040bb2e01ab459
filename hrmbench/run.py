"""One run of one cell of the benchmark, on the card:

    python3 -m hrmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It refuses to run without as many CUDA
cards as the cell asks for, and never falls back to the CPU. Earlier lines
(standard error) give the card, its power limit, the peak memory, the
cell's KV-pool and parameter bytes and the kernel library's build time;
the last lines of standard error are the numbers compared with the
reference, each beside its limit. The last line of standard output is the
result as one JSON object. The kernel library is built into ``build/``
inside the checkout, so only the first run of a checkout builds it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from hrmbench import harness  # noqa: E402


def _environment() -> None:
    """Caches inside the checkout, deterministic cuBLAS, the port on the
    path (it lives in the checkout's ``src``)."""
    build = harness.ROOT / "build"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(harness.ROOT / "src"))


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()
    if not (harness.ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    w, cell, config, mix = harness.cell_files(a.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < w["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {w['chips']} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind} x{torch.cuda.device_count()} (using {w['chips']}); "
          f"nvidia-smi: {_power_limit()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", file=sys.stderr)
    ctx = harness.Context(name=a.workload, cell=cell, config=config, mix=mix,
                          seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
                          device=dev, t0=T0, device_kind=kind)
    rec = harness.driver(cell["kind"]).run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    print(f"setup_s={rec['setup_s']:.3f} (kernel library load or build "
          f"{rec['build_s']:.3f} s) peak_memory_bytes="
          f"{rec['memory_peak_bytes']} kv_pool_bytes="
          f"{rec.get('kv_pool_bytes', 0)} param_bytes={rec['param_bytes']} "
          f"reference_s={rec['reference_s']:.3f}", file=sys.stderr)
    rec["device_kind"] = kind
    metrics = harness.read_metrics(a.workload, bool(a.trace), rec)
    device = {"platform": "gpu", "kind": kind, "count": w["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    breakdown = None
    if a.trace:
        prof = rec.get("profile")
        if prof is None or prof["busy_s"] <= 0:
            print("the traced window recorded no device time",
                  file=sys.stderr)
            return 5
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        breakdown = {"device_ops": prof["top_ops"],
                     "idle_gaps": prof["idle_by_host"]}
    print(f"judged: {json.dumps(rec['judged'])} ill-conditioned positions "
          f"left out: {rec.get('ill_conditioned_positions', 0)}",
          file=sys.stderr)
    if "strikes" in rec:
        print(f"strikes after the window: {json.dumps(rec['strikes'])}",
              file=sys.stderr)
    checks = harness.check_rows(rec)
    for c in checks:
        c["value"] = _finite(c["value"])
        print(f"check {c['name']}: {c['value']} (must be "
              f"{'at most' if c['kind'] == 'max' else 'at least'} "
              f"{c['limit']}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.result(rec, metrics, device, checks,
                                    breakdown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
