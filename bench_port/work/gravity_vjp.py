"""Work of one pullback of all-pairs gravity (the forces' VJP), self form:
B envs of N agents. 25 operations a pair (the forward's 11 and the
derivative of the quotient); bytes: the positions and the cotangent read
once, the position gradient written once, float32."""

PAIR_OPS = 25


def work(batch: int, n: int) -> dict:
    return {"fp32_ops": batch * n * n * PAIR_OPS, "bytes": 3 * batch * n * 2 * 4}
