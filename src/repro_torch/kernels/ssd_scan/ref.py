"""Plain PyTorch version of the Mamba2 SSD scan (port of
``repro.kernels.ssd_scan.ref``): the sequential recurrence, the definition the
chunked kernel is held against. The CPU path of :func:`ssd_scan.ssd_scan`."""
from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 s0: torch.Tensor):
    """Sequential SSD recurrence, O(T) steps.

    x: (B,T,H,P) dt-scaled inputs; a: (B,T,H) per-step log decay (<= 0);
    b, c: (B,T,N); s0: (B,H,P,N). Returns y (B,T,H,P) f32 and the final state
    (B,H,P,N) f32: ``s_t = exp(a_t) s_{t-1} + x_t (x) b_t``, ``y_t = s_t . c_t``.
    """
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    s = s0.float()
    ys = []
    for i in range(x.shape[1]):
        s = s * torch.exp(af[:, i])[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, i], bf[:, i])
        ys.append(torch.einsum("bhpn,bn->bhp", s, cf[:, i]))
    return torch.stack(ys, dim=1), s
