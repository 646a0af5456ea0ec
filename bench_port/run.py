"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload c5-rollout --seed 7 --seconds 20 --trace 0

From the root of a checkout. The cells are BENCHMARK.json's `workloads`;
--trace 1 reads the per-layer metrics from a device trace instead of the
end-to-end ones. The last line of standard output is one JSON object
(correct, attempted, failed, metrics, device; with --trace 1 breakdown),
the last lines of standard error each number compared and its limit.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of compiled kernels at fixed paths inside the checkout
_CACHE = os.path.join(ROOT, "bench_port", "out", "cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
# NCCL's shared-memory transport would keep files in /dev/shm; P2P over
# NVLink carries the hops between the cards of one host
os.environ["NCCL_SHM_DISABLE"] = "1"
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]


def early_ranks(argv):
    """Ranks 1.. of a mix that runs one process a card (its traffic's
    `processes`), started before this process imports torch, so that their
    start overlaps this one's: lib/ranks.start's (processes, port), or None
    for a mix of one process or a run that is itself a rank."""
    import json

    from bench_port.lib import ranks

    if "--rank" in argv or "--workload" not in argv:
        return None
    name = argv[argv.index("--workload") + 1]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = next((w for w in json.load(f)["workloads"] if w["name"] == name), None)
    if cell is None:
        return None
    with open(os.path.join(ROOT, "bench_port", "traffic", cell["traffic"] + ".json")) as f:
        processes = json.load(f).get("processes", 1)
    if processes < 2:
        return None
    return ranks.start([sys.executable, os.path.abspath(__file__), *argv], processes)


if __name__ == "__main__":
    RANKS = early_ranks(sys.argv[1:])
    from bench_port.lib import harness

    sys.exit(harness.main(sys.argv[1:], T0, RANKS))
