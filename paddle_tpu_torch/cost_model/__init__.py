"""``cost_model`` (counterpart of ``paddle_tpu/cost_model``): the time
of each op of a callable, measured where it runs.

``CostModel.profile_measure`` runs the callable under
``FLAGS_benchmark``, which makes ``call_op`` wait for each op's outputs
(``torch.cuda.synchronize`` on the card) and observe its time into the
``op_time_ms/<op>`` distribution of ``framework.monitor``; the table
holds each op's mean, call count and tails. ``estimate_flops`` reads the
JAX package's XLA cost analysis (``program_registry.analyze_callable``),
which waits on ROADMAP Queue 1 item 5, step 7.
"""
from __future__ import annotations

__all__ = ["CostModel"]


class CostModel:
    def __init__(self):
        self._costs = {}

    def profile_measure(self, fn_or_program, *args, device="tpu",
                        fetch_cost_list=("time",), repeat=3, **kwargs):
        """Run ``fn_or_program(*args, **kwargs)`` ``repeat`` times and
        return ``{op: {"time": mean seconds, "calls", "p95_ms",
        "p99_ms"}}`` from the dispatch layer's per-op times (``device``
        and ``fetch_cost_list`` are taken, as in the JAX package: the ops
        run where their operands are)."""
        from ..framework import flags as _flags
        from ..framework import monitor as _monitor
        old = _flags.get_flags("FLAGS_benchmark").get("FLAGS_benchmark")
        _flags.set_flags({"FLAGS_benchmark": True})
        _monitor.stat_reset()
        try:
            for _ in range(int(repeat)):
                fn_or_program(*args, **kwargs)
        finally:
            _flags.set_flags({"FLAGS_benchmark": bool(old)})
        self._costs = {}
        for key, h in _monitor.all_histograms().items():
            if not key.startswith("op_time_ms/"):
                continue
            op = key[len("op_time_ms/"):]
            self._costs[op] = {"time": h["sum"] / 1e3 / max(h["count"], 1),
                               "calls": int(h["count"]),
                               "p95_ms": h["p95"], "p99_ms": h["p99"]}
        return self._costs

    def static_cost_data(self):
        """The last measured table."""
        return self._costs

    def get_static_op_time(self, op_name, forward=True, dtype="float32"):
        key = op_name if forward else f"{op_name}_grad"
        if key in self._costs:
            return self._costs[key]
        raise ValueError(
            f"op {key!r} has no measured cost; run profile_measure first")


def estimate_flops(fn, *example_args):
    from ..ops.registry import not_ported
    raise not_ported("cost_model.estimate_flops (program_registry."
                     "analyze_callable)", "5, step 7")
