"""Hand kernels: ``attention_fwd`` (csrc/attention_fwd.cu) at the
128-token heads' N = 128 while hrnet-serve serves, the sum of each
launch's bound over the launches' device time.  A launch at
[b, H, N, Dh] bf16 reads q, k, v and writes o once (4 b H N Dh x 2
bytes) and does 4 b H N^2 Dh operations on the tensor cores; each
traced request's chunks (the serving ladder) launch one a layer: at
[32, 8, 128, 64], 16.8 MB against 3.35 TB/s, about 5.0 us, 3 a bucket-32
replay."""

from harness import yardstick


def launch_bound(b, model):
    h, n, d = model["heads"], model["tokens"], model["dim_head"]
    return yardstick.bound_s(4 * b * h * n * d * 2, 4 * b * h * n * n * d)


def read(trace, work, config, traffic):
    model = config["model"]
    bounds = [launch_bound(b, model)
              for n in work.get("trace_sizes", ())
              for b in yardstick.chunks(n, work["buckets"])
              for _ in range(model["depth"])]
    return yardstick.roofline_pct(trace, ("attention_fwd",),
                                  "attention_fwd", bounds)
