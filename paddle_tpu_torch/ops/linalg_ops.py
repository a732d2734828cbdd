"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg_ops.py``):
products, norms and the decompositions through ``torch.linalg``, which
runs on the card. ``lstsq`` is the SVD solve the JAX op (numpy's
algorithm) does, so the card needs no LAPACK driver it lacks;
``matrix_nms`` runs on the boxes' device with torch ops (its output count
depends on the data, as in the JAX op, which runs it on the host)."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_op("dot")
def _dot(x, y):
    return (x * y).sum(-1)


@register_op("bmm")
def _bmm(x, y):
    return torch.matmul(x, y)


@register_op("mv")
def _mv(x, vec):
    return torch.matmul(x, vec)


@register_op("outer")
def _outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_op("inner")
def _inner(x, y):
    return torch.inner(x, y)


@register_op("cross")
def _cross(x, y, axis=None):
    if axis is None:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=axis)


@register_op("kron")
def _kron(x, y):
    return torch.kron(x, y)


@register_op("addmm")
def _addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@register_op("einsum")
def _einsum(xs, equation=""):
    return torch.einsum(equation, *xs)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@register_op("p_norm")
def _p_norm(x, porder=2.0, axis=None, keepdim=False, epsilon=1e-12):
    ax = _axes(axis)
    kw = {} if ax is None else {"dim": ax, "keepdim": keepdim}
    if porder == float("inf"):
        return x.abs().amax(**kw)
    if porder == float("-inf"):
        return x.abs().amin(**kw)
    if porder == 0:
        return (x != 0).to(x.dtype).sum(**kw)
    return (x.abs() ** porder).sum(**kw) ** (1.0 / porder)


@register_op("frobenius_norm")
def _frobenius_norm(x, axis=None, keepdim=False):
    return torch.sqrt((x * x).sum(dim=_axes(axis), keepdim=keepdim))


for _name, _fn in {
    "cholesky": torch.linalg.cholesky,
    "inverse": torch.linalg.inv,
    "pinv": torch.linalg.pinv,
    "slogdet": lambda x: tuple(torch.linalg.slogdet(x)),
    "det": torch.linalg.det,
}.items():
    register_op(_name)(_fn)


@register_op("matrix_rank")
def _matrix_rank(x, rtol=None):
    """The rank: singular values above ``rtol`` times the largest
    (default ``eps * max(m, n)``, as ``jnp.linalg.matrix_rank``)."""
    return torch.linalg.matrix_rank(x, rtol=rtol)


@register_op("qr")
def _qr(x, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(x, mode="r")[1]
    return tuple(torch.linalg.qr(x, mode=mode))


@register_op("svd")
def _svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@register_op("eig")
def _eig(x):
    w, v = torch.linalg.eig(x)
    return w, v


@register_op("eigh")
def _eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@register_op("eigvals")
def _eigvals(x):
    return torch.linalg.eigvals(x)


@register_op("eigvalsh")
def _eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@register_op("matrix_power")
def _matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


@register_op("solve")
def _solve(x, y):
    return torch.linalg.solve(x, y)


@register_op("triangular_solve")
def _triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=bool(upper) != bool(transpose), left=True,
        unitriangular=unitriangular)


@register_op("cholesky_solve")
def _cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, y, upper=upper)


@register_op("lstsq")
def _lstsq(x, y, rcond=None):
    """The JAX op's least squares (``jnp.linalg.lstsq``): the minimum-norm
    solution through the SVD, cutting singular values below ``rcond``
    times the largest; the residuals are always the squared column norms
    of ``y - x @ sol``."""
    m, n = x.shape[-2], x.shape[-1]
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(m, n)
    elif rcond < 0:
        rcond = torch.finfo(x.dtype).eps
    mask = (s > 0) & (s >= rcond * s[0])
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1.0 / safe, torch.zeros_like(s))[:, None]
    sol = vh.transpose(-1, -2).conj() @ (s_inv * (u.transpose(-1, -2).conj()
                                                 @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, mask.sum(), s


@register_op("lu")
def _lu(x):
    lu, piv = torch.linalg.lu_factor(x)
    return lu, piv.to(torch.int32)           # 1-based, as the reference's


@register_op("histogram")
def _histogram(x, bins=100, min=0, max=0):
    xf = x.float() if not x.is_floating_point() else x
    if min == 0 and max == 0:
        lo, hi = xf.min(), xf.max()
        lo, hi = float(lo), float(hi)
    else:
        lo, hi = float(min), float(max)
    return torch.histc(xf, bins=int(bins), min=lo, max=hi).to(torch.int64)


@register_op("bincount")
def _bincount(x, weights=None, minlength=0):
    out = torch.bincount(x, weights=weights, minlength=int(minlength))
    return out.to(weights.dtype) if weights is not None else out


def _mnms_iou(boxes, normalized):
    """Pairwise IoU ``[m, m]`` of ``[m, 4]`` xyxy boxes. Unnormalized boxes
    count inclusive pixels (+1), and overlap is zero only on strict
    separation per axis (the reference's ``JaccardOverlap``)."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    separated = (lt > rb).any(-1)
    wh = (rb - lt + off).clamp_min(0.0)
    inter = torch.where(separated, torch.zeros_like(wh[..., 0]),
                        wh[..., 0] * wh[..., 1])
    area = (boxes[:, 2:] - boxes[:, :2] + off).prod(1)
    return inter / (area[:, None] + area[None, :] - inter + 1e-10)


@register_op("matrix_nms")
def _matrix_nms(bboxes, scores, score_threshold=0.0, post_threshold=0.0,
                nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
                gaussian_sigma=2.0, background_label=0, normalized=True):
    """Matrix NMS (SOLOv2): each candidate's score decays by
    ``min_i f(iou_ij) / f(comp_i)`` over the higher-scored boxes i of its
    class, ``comp_i`` being box i's own largest IoU with a better box.
    ``bboxes [N, M, 4]`` xyxy, ``scores [N, C, M]``; returns ``(out [No,
    6]`` rows ``[label, score, x1, y1, x2, y2]`` by decayed score per
    image, ``index [No, 1]`` = ``n * M + m``, ``rois_num [N]`` int32)."""
    dev = bboxes.device
    N, M, _ = bboxes.shape
    C = scores.shape[1]
    dtype = scores.dtype if scores.dtype in (torch.float32, torch.float64) \
        else torch.float32
    rows, idxs, rois_num = [], [], []
    for n in range(N):
        cls_l, score_l, box_l, idx_l = [], [], [], []
        for c in range(C):
            if c == background_label:
                continue
            sc = scores[n, c]
            cand = torch.nonzero(sc > score_threshold)[:, 0]
            if cand.numel() == 0:
                continue
            order = cand[torch.argsort(-sc[cand], stable=True)]
            if 0 <= nms_top_k < order.numel():
                order = order[:nms_top_k]
            iou = torch.triu(_mnms_iou(bboxes[n, order], normalized), 1)
            comp = iou.amax(0)
            if use_gaussian:
                decay = torch.exp((comp[:, None] ** 2 - iou ** 2)
                                  * gaussian_sigma)
            else:
                # comp == 1 (duplicate boxes) gives inf or nan, which lose
                # the min or fail the keep test as in the reference
                decay = (1.0 - iou) / (1.0 - comp[:, None])
            new_sc = sc[order] * decay.amin(0)
            keep = torch.nonzero(new_sc > post_threshold)[:, 0]
            cls_l.append(torch.full((keep.numel(),), float(c), dtype=dtype,
                                    device=dev))
            score_l.append(new_sc[keep].to(dtype))
            box_l.append(bboxes[n, order[keep]].to(dtype))
            idx_l.append(n * M + order[keep])
        if cls_l:
            cls_a, score_a = torch.cat(cls_l), torch.cat(score_l)
            box_a, idx_a = torch.cat(box_l), torch.cat(idx_l)
            top = torch.argsort(-score_a, stable=True)
            if 0 <= keep_top_k < top.numel():
                top = top[:keep_top_k]
            rows.append(torch.cat([cls_a[top, None], score_a[top, None],
                                   box_a[top]], dim=1))
            idxs.append(idx_a[top])
            rois_num.append(top.numel())
        else:
            rois_num.append(0)
    if rows:
        out = torch.cat(rows).to(dtype)
        index = torch.cat(idxs).to(torch.int64)[:, None]
    else:
        out = torch.zeros((0, 6), dtype=dtype, device=dev)
        index = torch.zeros((0, 1), dtype=torch.int64, device=dev)
    return out, index, torch.tensor(rois_num, dtype=torch.int32, device=dev)


@register_op("cond")
def _cond(x, p=None):
    return torch.linalg.cond(x, p=p)


@register_op("multi_dot")
def _multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))
