"""A run with the timed path broken underneath comes out as not correct,
once for each fault a one-card cell can have (there is no exchange
between cards to leave out)."""
import pytest

from conftest import drive

UNCHANGED = """
import torch, miso_tpu_torch.pipeline as pl
real = pl.run_sampler
def stuck(seed, batch, cfg, start_psi, pad_reads):
    res = real(seed, batch, cfg, start_psi, pad_reads)
    psi = res.psi_samples
    k = torch.as_tensor(batch.num_iso, device=psi.device)
    iso = torch.arange(psi.shape[-1], device=psi.device)
    start = torch.where(iso[None, :] < k[:, None],
                        1.0 / k.clamp_min(1)[:, None].float(), 0.0)
    return res._replace(psi_samples=start[:, None, None, :].expand_as(
        psi).contiguous())
pl.run_sampler = stuck
"""

HALF = """
import miso_tpu_torch.pipeline as pl
real = pl.StreamRunner._materialize_chunk
def half(self, p):
    n = (len(p["evs"]) + 1) // 2
    return real(self, dict(p, evs=p["evs"][:n], tags=p["tags"][:n]))
pl.StreamRunner._materialize_chunk = half
"""

ALTERED = """
import miso_tpu_torch._host as host
for name in ("compile_single_end_many", "compile_paired_end_many"):
    real = getattr(host, name)
    def altered(*a, _real=real, **k):
        evs = _real(*a, **k)
        for ev in evs or []:
            if ev is not None:
                ev.classes.counts[0] += 1
                ev.counts[0] += 1
        return evs
    setattr(host, name, altered)
"""


# reads put in the wrong class at the compile, the totals kept: two
# compatible classes of different sizes swap their read counts, in the
# classes and in the sampler's tensors alike (a paired .miso header
# prints every class as zeros, so only the compiled classes show it)
SWAPPED = """
import numpy as np, miso_tpu_torch._host as host
def swap(ev):
    if ev is None:
        return ev
    c = ev.classes
    ok = np.flatnonzero((np.asarray(c.templates) > 0).any(0))
    other = [j for j in ok[1:] if c.counts[j] != c.counts[ok[0]]]
    if other:
        i, j = ok[0], other[0]
        c.counts[i], c.counts[j] = c.counts[j], c.counts[i]
        if not np.shares_memory(ev.counts, c.counts):
            dj = int(np.searchsorted(ok, j))
            ev.counts[0], ev.counts[dj] = ev.counts[dj], ev.counts[0]
    return ev
for name in ("compile_single_end_many", "compile_paired_end_many",
             "compile_single_end", "compile_paired_end"):
    if hasattr(host, name):
        real = getattr(host, name)
        def swapped(*a, _real=real, **k):
            out = _real(*a, **k)
            if isinstance(out, list):
                return [swap(ev) for ev in out]
            return swap(out)
        setattr(host, name, swapped)
"""


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "swapped"])
@pytest.mark.parametrize("cell", ["se_tiny.tiny", "pe_tiny.tiny"])
def test_a_broken_timed_path_is_not_correct(bench_copy, cell, fault):
    patch = {"unchanged": UNCHANGED, "half": HALF, "altered": ALTERED,
             "swapped": SWAPPED}[fault]
    res = drive(bench_copy, cell, patch=patch)["result"]
    assert not res["correct"], res["checks"]
