"""Work of one all-pairs gravity evaluation, self form: B envs of N agents.

Operations per pair, counted from the force law's expressions (a divide
as one): the difference (2), the squared distance and bias (4), the two
quotients (2), the sums (2) and the scale by g (1) = 11. Bytes: the
positions read once and the forces written once, float32.
"""

PAIR_OPS = 11


def work(batch: int, n: int) -> dict:
    return {"fp32_ops": batch * n * n * PAIR_OPS, "bytes": 2 * batch * n * 2 * 4}
