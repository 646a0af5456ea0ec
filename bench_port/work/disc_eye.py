"""Work of one render of the disc eye: B envs of N agents, each seeing its
env's N agents on a W-pixel line.

Operations: 16 a (eye, target) pair (the offset, the depth and lateral
products, the depth test, the divides for u and du, the frustum test) and
6 a covering (eye, target, pixel) triple (the offset, its test, the depth
compare); the covering triples are counted from the inputs
(reference/disc_eye.py's winners, its stats' "covered"). Bytes: positions
and headings read once, the shade and depth lines written once, float32.
"""

PAIR_OPS, PIXEL_OPS = 16, 6


def work(batch: int, n: int, width: int, covered: int) -> dict:
    return {"fp32_ops": batch * n * n * PAIR_OPS + covered * PIXEL_OPS,
            "bytes": 2 * batch * n * 2 * 4 + 2 * batch * n * width * 4}


def renders(batch: int, n: int, width: int, count: int, stats: dict) -> dict:
    """The work of `count` renders whose reference stats, summed over them,
    are `stats`."""
    one = work(batch, n, width, 0)
    return {"fp32_ops": one["fp32_ops"] * count + stats.get("covered", 0) * PIXEL_OPS,
            "bytes": one["bytes"] * count}
