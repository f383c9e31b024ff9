"""The batch losses and metrics in plain PyTorch, float32.

The original protein-transformer's definitions, on padded batches with
explicit masks: the angle MSE over the valid sin/cos entries (all, backbone
= the first 6 angles' 12 columns, sidechain = the rest); the dRMSD of each
protein over the valid atom pairs i < j, sqrt(mean (|a_i - a_j| -
|b_i - b_j|)^2), over the 14 atom slots and over the backbone's N, CA, C;
ln-dRMSD = dRMSD over the protein's number of valid atoms; the combined
loss 0.5 ln-dRMSD / 0.02 + 0.5 MSE / 0.01; the superposition RMSD after a
weighted Kabsch fit; every batch value a mean over the real proteins.

The pair sweep runs over blocks of rows so that no (N, N) matrix is held
whole, and its gradient in the predicted coordinates is written out
(``PairSweep``), so that a batch of 7,000-atom proteins fits.
"""
from __future__ import annotations

import torch

DIST_CLAMP = 1e-30
# elements of one (proteins, rows, atoms) block of the sweep
BLOCK_ELEMENTS = 1 << 24


def _blocks(bsz: int, n: int):
    rows = max(1, min(n, BLOCK_ELEMENTS // max(n, 1)))
    per = max(1, BLOCK_ELEMENTS // max(rows * n, 1))
    for p0 in range(0, bsz, per):
        for r0 in range(0, n, rows):
            yield slice(p0, min(p0 + per, bsz)), r0, min(r0 + rows, n)


def _dist(x, r0, r1):
    diff = x[:, r0:r1, None, :] - x[:, None, :, :]
    d2 = torch.clamp(torch.sum(diff * diff, dim=-1), min=DIST_CLAMP)
    inv = torch.rsqrt(d2)
    return diff, d2 * inv, inv


def pair_sweep(a, b, mask, want_grad: bool):
    """(S (B,), C (B,), dS/da (B, N, 3) or None) over valid pairs i < j."""
    bsz, n, _ = a.shape
    s = torch.zeros(bsz, dtype=a.dtype, device=a.device)
    c = torch.zeros(bsz, dtype=torch.int64, device=a.device)
    g = torch.zeros_like(a) if want_grad else None
    cols = torch.arange(n, device=a.device)
    for ps, r0, r1 in _blocks(bsz, n):
        pair = (mask[ps, r0:r1, None] & mask[ps, None, :]
                & (cols[r0:r1, None] < cols[None, :]))
        diff_a, da, inv_a = _dist(a[ps], r0, r1)
        _, db, _ = _dist(b[ps], r0, r1)
        delta = torch.where(pair, da - db, 0.0)
        s[ps] += torch.sum(delta * delta, dim=(1, 2))
        c[ps] += torch.sum(pair, dim=(1, 2))
        if want_grad:
            term = (2 * delta * inv_a)[..., None] * diff_a
            g[ps, r0:r1] += term.sum(dim=2)
            g[ps] -= term.sum(dim=1)
    return s, c, g


class PairSweep(torch.autograd.Function):
    """S and C of ``pair_sweep``, differentiable in a."""

    @staticmethod
    def forward(ctx, a, b, mask):
        s, c, g = pair_sweep(a, b, mask, a.requires_grad)
        ctx.save_for_backward(g)
        ctx.mark_non_differentiable(c)
        return s, c

    @staticmethod
    def backward(ctx, ds, _dc):
        (g,) = ctx.saved_tensors
        return (None if g is None else g * ds[:, None, None]), None, None


def drmsd(a, b, mask):
    """Per-protein dRMSD of (B, N, 3) point sets over valid pairs."""
    a = a.contiguous()
    if torch.is_grad_enabled() and a.requires_grad:
        s, c = PairSweep.apply(a, b, mask)
    else:
        s, c, _ = pair_sweep(a, b, mask, False)
    return torch.sqrt(torch.clamp(s / torch.clamp(c, min=1).to(s.dtype),
                                  min=DIST_CLAMP))


def masked_mse(pred, true, mask):
    sq = torch.where(mask, (pred - true) ** 2, 0.0)
    return torch.sum(sq) / torch.clamp(torch.sum(mask), min=1)


def kabsch_rmsd(a, b, w):
    """Per-protein RMSD of a onto b after a weighted Kabsch fit; a, b
    (B, N, 3), w (B, N) 0/1."""
    w = w.to(a.dtype)[..., None]
    total = torch.clamp(torch.sum(w, dim=-2), min=1.0)
    am = torch.sum(a * w, dim=-2) / total
    bm = torch.sum(b * w, dim=-2) / total
    ac, bc = (a - am[:, None]) * w, (b - bm[:, None]) * w
    h = torch.einsum("bni,bnj->bij", ac.double(), bc.double())
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(u @ vt))
    u = torch.cat([u[..., :2], u[..., 2:] * d[:, None, None]], dim=-1)
    rot = (u @ vt).to(a.dtype)
    aligned = torch.einsum("bni,bij->bnj", a - am[:, None], rot)
    diff = (aligned - (b - bm[:, None])) * w
    return torch.sqrt(torch.sum(diff ** 2, dim=(-2, -1)) / total[:, 0])


def real_mean(v, protein_mask):
    w = protein_mask.to(v.dtype)
    return torch.sum(v * w) / torch.clamp(torch.sum(w), min=1.0)


def batch_metrics(pred, crd_pred, batch: dict, spec: dict,
                  with_rmsd: bool) -> dict:
    """The batch's metrics from predictions (B, L, 24) and predicted
    coordinates (B, L, 14, 3). ``spec``: the configuration's ``loss``,
    ``backbone_loss`` and ``combined_drmsd_weight``. With ``backbone_loss``
    the dRMSD and RMSD are taken over the backbone alone and reported in
    the full slots too."""
    ang, ang_mask = batch["ang"], batch["ang_mask"]
    crd, crd_mask, pm = batch["crd"], batch["crd_mask"], batch["protein_mask"]
    bsz = pred.shape[0]
    out = {"mse-full": masked_mse(pred, ang, ang_mask),
           "mse-bb": masked_mse(pred[..., :12], ang[..., :12],
                                ang_mask[..., :12]),
           "mse-sc": masked_mse(pred[..., 12:], ang[..., 12:],
                                ang_mask[..., 12:])}
    m_bb = crd_mask[:, :, :3].reshape(bsz, -1)
    bb = drmsd(crd_pred[:, :, :3].reshape(bsz, -1, 3),
               crd[:, :, :3].reshape(bsz, -1, 3), m_bb)
    ln_bb = bb / torch.clamp(m_bb.sum(-1), min=1)
    bb_only = spec["backbone_loss"]
    if bb_only:
        full, ln_full = bb, ln_bb
    else:
        m = crd_mask.reshape(bsz, -1)
        full = drmsd(crd_pred.reshape(bsz, -1, 3), crd.reshape(bsz, -1, 3), m)
        ln_full = full / torch.clamp(m.sum(-1), min=1)
    out.update({k: real_mean(v, pm) for k, v in (
        ("drmsd-full", full), ("lndrmsd-full", ln_full), ("drmsd-bb", bb),
        ("lndrmsd-bb", ln_bb))})
    ln_train = out["lndrmsd-bb"] if bb_only else out["lndrmsd-full"]
    w = spec["combined_drmsd_weight"]
    out["combined-full"] = (w * ln_train / 0.02
                            + (1 - w) * out["mse-full"] / 0.01)
    out["loss"] = {"combined": out["combined-full"], "lndrmsd": ln_train,
                   "drmsd": out["drmsd-bb"] if bb_only else out["drmsd-full"],
                   "mse": out["mse-full"]}[spec["loss"]]
    if with_rmsd:
        sl = slice(0, 3) if bb_only else slice(None)
        r = kabsch_rmsd(crd_pred[:, :, sl].reshape(bsz, -1, 3),
                        crd[:, :, sl].reshape(bsz, -1, 3),
                        crd_mask[:, :, sl].reshape(bsz, -1))
        out["rmsd-full"] = real_mean(r, pm)
    return out
