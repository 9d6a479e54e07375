"""The sampler kernels' share of their roofline: the sum over the traced
window's launches of each launch's least time (``roofline.launch``, from
the batch's sufficient statistics, whichever kernel ran it) over the
summed device time of the sampler kernels, in percent."""


def read(trace):
    ns = sum(b - a for name, a, b in trace.device_ops
             if trace.is_sampler_kernel(name))
    least = sum(x["seconds"] for x in trace.recorder.launches)
    if ns <= 0 or least <= 0:
        return None
    return 100.0 * least / (ns / 1e9)
