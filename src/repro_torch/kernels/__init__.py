"""Hand-written CUDA kernels of the port and their launch counters.

Each kernel's wrapper counts its launches in a plain int attribute
(``<wrapper>.launches``); :func:`launch_counts` reads them all and
:func:`reset_launches` sets them to 0, so a run can show that its main path
went through every kernel. A replayed CUDA graph runs no Python, so the
captured step programs (``core.interleave``) add each graph's launches with
:func:`add_launches` on every replay.
"""
from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.pim_gemv import pim_gemv as pg
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    return {
        "pim_gemv": pg.pim_gemv,
        "decode_attention": da.decode_attention,
        "decode_attention_paged": da.decode_attention_paged,
        "decode_attention_paged_split": da.split_partials,
        "merge_splits": da.merge_splits,
        "ssd_scan": ss.ssd_scan,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches, negative to take back) to the
    counters."""
    wrappers = _wrappers()
    for name, n in delta.items():
        wrappers[name].launches += n
