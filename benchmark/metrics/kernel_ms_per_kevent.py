"""Sampler kernels' device milliseconds per 1,000 events: the summed
``torch.profiler`` device time of the program's sampler kernels (B1, B1w,
B2, B2w, B3: every ``__global__`` function of its CUDA sources but the
probes) in the traced window."""


def read(trace):
    ns = sum(b - a for name, a, b in trace.device_ops
             if trace.is_sampler_kernel(name))
    if not trace.events or ns <= 0:
        return None
    return ns / 1e6 / (trace.events / 1e3)
