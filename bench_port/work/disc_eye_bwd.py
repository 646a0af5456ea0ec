"""Work of one pullback of the disc eye: B envs of N agents, W-pixel lines.

Operations: 60 a pixel that a target wins (the winner's offset, coverage
and shade and their derivatives), the won pixels counted from the inputs
(reference/disc_eye.py's winners, its stats' "won"). Bytes (chip_smoke.py's
count): positions, headings, the forward's int32 winner index and both
float32 cotangent lines read once, the eye, heading and target gradients
written once.
"""

PIXEL_OPS = 60


def work(batch: int, n: int, width: int, won: int) -> dict:
    return {"fp32_ops": won * PIXEL_OPS,
            "bytes": 2 * batch * n * 2 * 4 + 3 * batch * n * width * 4 + 3 * batch * n * 2 * 4}


def renders(batch: int, n: int, width: int, count: int, stats: dict) -> dict:
    """The work of `count` pullbacks whose renders' reference stats, summed
    over them, are `stats`."""
    return {"fp32_ops": stats.get("won", 0) * PIXEL_OPS,
            "bytes": work(batch, n, width, 0)["bytes"] * count}
