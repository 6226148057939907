"""IVF-PQ look-up-table scan: the ``pq_scan`` kernel and its plain version.

Counterpart of raft_tpu/ops/pq_scan.py (``pq_lut_scan``, the Pallas LUT16
sweep behind ``SearchParams(scan_impl="pallas")``). For every (query, probe)
pair of a search step the function scores every slot of the list the pair
probes::

    pq4:        out[b, j] = sum_s lut[b, s, c & 15]
    split pq8:  out[b, j] = sum_s (lut[b, s, c >> 4] + lut[b, s, 16 + (c & 15)])

with ``c = list_codes[probe_lists[b], j, s]``, summed in float32 in subspace
order. Unlike ``pq_lut_scan``, which takes the gathered (pairs, cap, S) code
planes and a (pairs, K, S) LUT, this takes the index's ``list_codes`` as
stored and the probed list ids, and the LUT in ``ivf_pq._pq_search``'s own
(pairs, S, K) layout: the CUDA kernel (``csrc/pq_scan.cu``; see its header
for the design and its bound) follows the list ids itself, so the code gather
never reaches device memory. The TPU kernel's lane packing and padding of S
are TPU artefacts and are not carried over.

:func:`pq_scan_plain` sums in the same order as the kernel, so on the card
the two agree bit for bit. :func:`pq_scan` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; there is no fallback from
one to the other. ``pq_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.errors import expects

__all__ = ["pq_scan", "pq_scan_plain"]

_LUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448            # shared memory a block can use (H100)
_THREADS = 256                # the kernel's slots per block


def _check(list_codes, probe_lists, lut, split):
    expects(list_codes.ndim == 3 and list_codes.dtype == torch.uint8,
            "pq_scan: list_codes must be (n_lists, cap, S) uint8, got %s %s",
            tuple(list_codes.shape), list_codes.dtype)
    expects(probe_lists.ndim == 1 and probe_lists.dtype == torch.int32,
            "pq_scan: probe_lists must be (pairs,) int32, got %s %s",
            tuple(probe_lists.shape), probe_lists.dtype)
    _, cap, s = list_codes.shape
    k = 32 if split else 16
    expects(tuple(lut.shape) == (probe_lists.shape[0], s, k),
            "pq_scan: lut must be (pairs=%d, S=%d, K=%d), got %s",
            probe_lists.shape[0], s, k, tuple(lut.shape))
    expects(lut.dtype in _LUT_CODE, "pq_scan: lut must be float32 or bfloat16, got %s",
            lut.dtype)
    expects(list_codes.device == probe_lists.device == lut.device,
            "pq_scan: list_codes, probe_lists and lut must be on one device")
    return cap, s


def pq_scan_plain(list_codes, probe_lists, lut, split: bool = False):
    """Plain PyTorch version of the ``pq_scan`` kernel: the same arguments,
    the same (pairs, cap) float32 scores, on any device."""
    cap, s_dim = _check(list_codes, probe_lists, lut, split)
    lutf = lut.to(torch.float32)
    rows = probe_lists.to(torch.int64)
    acc = torch.zeros((rows.shape[0], cap), dtype=torch.float32, device=lut.device)
    for s in range(s_dim):
        c = list_codes[rows, :, s].to(torch.int64)     # (pairs, cap)
        table = lutf[:, s, :]                           # (pairs, K)
        if split:
            acc = acc + (torch.gather(table, 1, c >> 4)
                         + torch.gather(table, 1, 16 + (c & 15)))
        else:
            acc = acc + torch.gather(table, 1, c & 15)
    return acc


def _launch(list_codes, probe_lists, lut, split):
    from ._build import load

    for t, name in ((list_codes, "list_codes"), (probe_lists, "probe_lists"), (lut, "lut")):
        expects(t.is_contiguous(), "pq_scan: %s must be contiguous", name)
    n_lists, cap, s = list_codes.shape
    pairs = probe_lists.shape[0]
    expects(pairs > 0 and cap > 0 and s > 0, "pq_scan needs pairs, slots and subspaces")
    expects(s * lut.shape[2] * 4 <= _MAX_SMEM,
            "pq_scan: a %d x %d float32 LUT exceeds a block's shared memory", s, lut.shape[2])
    expects(-(-cap // _THREADS) <= 65535, "pq_scan: cap=%d is too large", cap)
    lib = load("pq_scan")
    fn = lib.pq_scan_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    out = torch.empty((pairs, cap), dtype=torch.float32, device=lut.device)
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fn(_LUT_CODE[lut.dtype], int(split), list_codes.data_ptr(),
                 probe_lists.data_ptr(), lut.data_ptr(), pairs, n_lists, cap, s,
                 out.data_ptr(), stream)
    pq_scan.launches += 1
    expects(err == 0, "pq_scan kernel launch failed: cudaError %d", err)
    return out


def pq_scan(list_codes, probe_lists, lut, split: bool = False):
    """Scores (pairs, cap) float32 of every slot of the list each pair probes.

    ``list_codes`` (n_lists, cap, S) uint8 as an IVF-PQ index stores them;
    ``probe_lists`` (pairs,) int32, the list each (query, probe) pair scans;
    ``lut`` (pairs, S, K) float32 or bfloat16, K = 16, or 32 with ``split``
    (nibble-split pq8: the high nibble indexes columns 0-15, the low nibble
    columns 16-31). A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`pq_scan_plain`.
    """
    _check(list_codes, probe_lists, lut, split)
    if lut.device.type == "cpu":
        return pq_scan_plain(list_codes, probe_lists, lut, split)
    expects(lut.device.type == "cuda", "pq_scan runs on cuda or cpu tensors, got %s",
            lut.device)
    return _launch(list_codes, probe_lists, lut, bool(split))


pq_scan.launches = 0
