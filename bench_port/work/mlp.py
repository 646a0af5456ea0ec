"""Work of the policy MLP over `rows` observations: 2 flops a
multiply-add, the hidden layers in bfloat16 on the tensor cores, the head
in float32. `backward` adds the weight and input gradients (twice the
forward's flops)."""


def work(rows: int, obs_dim: int, hidden, act_dim: int, backward: bool = False) -> dict:
    dims = [obs_dim, *hidden]
    hid = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])) * rows
    head = 2 * dims[-1] * act_dim * rows
    scale = 3 if backward else 1
    return {"bf16_flops": hid * scale, "fp32_ops": head * scale, "bytes": 0}
