"""Hand kernels: ``attention_bwd`` (csrc/attention_bwd.cu) while
training, the sum of each launch's bound over the launches' device
time: one launch a layer a step at [batch, H, N, Dh] bf16, reading q, k,
v, do and writing dq, dk, dv once (7 b H N Dh x 2 bytes), 10 b H N^2 Dh
operations on the tensor cores (P and dP recomputed, dV, dQ, dK)."""

from harness import yardstick


def read(trace, work, config, traffic):
    m = config["model"]
    b, h, n, d = work["batch"], m["heads"], m["tokens"], m["dim_head"]
    one = yardstick.bound_s(7 * b * h * n * d * 2, 10 * b * h * n * n * d)
    bounds = [one] * (m["depth"] * work.get("trace_steps", 0))
    return yardstick.roofline_pct(trace, ("attention_bwd",),
                                  "attention_bwd", bounds)
