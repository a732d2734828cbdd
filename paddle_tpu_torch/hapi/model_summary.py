"""``summary`` and ``flops`` (counterpart of ``paddle_tpu/hapi/
model_summary.py``): each leaf layer's output shape and parameter count
through forward post-hooks, and the FLOPs of one forward.

``flops`` counts with ``torch.utils.flop_counter.FlopCounterMode``:
matrix products and convolutions by their analytic counts (2 per
multiply-add; biases and elementwise work are not counted), and the
port's flash attention custom op (``paddle_tpu_torch::flash_attention_fwd``,
K4) by the formula torch uses for ``scaled_dot_product_attention``: its
two products over the whole ``Sq x Sk`` square, causal or not. The JAX
package reads XLA's cost analysis instead, which also counts elementwise
work, so the two agree exactly only on networks of products.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["summary", "flops"]


def _net_device(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


def _spec_to_input(input_size, dtypes, device):
    """One input per shape of ``input_size`` (``None``/-1 dims as 1):
    zeros for an integer dtype, else uniform draws in [-1, 1] from numpy's
    global state, as in the JAX package."""
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        sizes = list(input_size)
    else:
        sizes = [tuple(input_size)]
    dtypes = dtypes or ["float32"] * len(sizes)
    if isinstance(dtypes, str):
        dtypes = [dtypes] * len(sizes)
    outs = []
    for shape, dt in zip(sizes, dtypes):
        shape = tuple(1 if (s in (-1, None)) else int(s) for s in shape)
        if str(dt).startswith("int"):
            arr = np.zeros(shape, dtype=dt)
        else:
            arr = np.random.uniform(-1, 1, shape).astype(dt)
        outs.append(torch.from_numpy(arr).to(device))
    return outs


def _inputs(net, input_size, dtypes, given, what):
    if given is not None:
        return list(given) if isinstance(given, (list, tuple)) else [given]
    if input_size is None:
        raise ValueError(f"{what} needs input_size or input")
    return _spec_to_input(input_size, dtypes, _net_device(net))


def summary(net, input_size=None, dtypes=None, input=None):
    """Print the table of ``net``'s leaf layers (output shape, parameters)
    from one forward in eval mode without gradients, and return
    ``{"total_params", "trainable_params"}``."""
    rows, handles = [], []

    def make_hook(name):
        def hook(lyr, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            n_params = sum(p.numel() for p in lyr._parameters.values()
                           if p is not None)
            rows.append((name or type(lyr).__name__, type(lyr).__name__,
                         list(getattr(out, "shape", [])), n_params))

        return hook

    subs = [(n, m) for n, m in net.named_modules() if m is not net]
    if not subs:            # the model is itself a leaf layer
        handles.append(net.register_forward_hook(
            make_hook(type(net).__name__)))
    for name, sub in subs:
        # leaf layers only: a container's shapes repeat its children's
        if next(sub.children(), None) is None:
            handles.append(sub.register_forward_hook(make_hook(name)))
    was_training = net.training
    net.eval()
    try:
        args = _inputs(net, input_size, dtypes, input, "summary")
        with torch.no_grad():
            net(*args)
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    w_name = max([len(r[0]) + len(r[1]) + 3 for r in rows] + [20])
    lines = ["-" * (w_name + 40),
             f"{'Layer (type)':<{w_name}} {'Output Shape':<22} "
             f"{'Param #':>12}",
             "=" * (w_name + 40)]
    for name, ltype, shape, n_params in rows:
        lines.append(f"{name + ' (' + ltype + ')':<{w_name}} "
                     f"{str(shape):<22} {n_params:>12,}")
    lines += ["=" * (w_name + 40),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * (w_name + 40)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def _register_flash_formula():
    """K4's custom op under the FLOP counter: 4 B H Sq Sk D, the two
    products of attention (``[B, S, H, D]`` operands). Registered once."""
    from torch.utils import flop_counter

    from ..ops import flash_attention  # noqa: F401  (defines the op)
    op = torch.ops.paddle_tpu_torch.flash_attention_fwd
    if op in flop_counter.flop_registry:
        return

    @flop_counter.register_flop_formula(op)
    def _flash_fwd_flop(q_shape, k_shape, v_shape, *args, out_shape=None,
                        **kwargs) -> int:
        b, sq, h, d = q_shape
        return 4 * b * h * sq * k_shape[1] * d


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail: bool = False) -> int:
    """The FLOPs of one forward of ``net`` on ``inputs`` (or on an input of
    ``input_size``), counted by ``FlopCounterMode`` (module docstring).
    ``custom_ops`` (the reference's per-layer counting functions) is not
    ported yet (ROADMAP Queue 1 item 5)."""
    from torch.utils.flop_counter import FlopCounterMode
    if custom_ops:
        from ..ops.registry import not_ported
        raise not_ported("flops(custom_ops=...)", 5)
    _register_flash_formula()
    args = _inputs(net, input_size, None, inputs, "flops")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(*args)
    total = int(counter.get_total_flops())
    if print_detail:
        print(f"Total Flops: {total}")
    return total
