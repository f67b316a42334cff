"""The DCP look as a pipeline step (counterpart of
``art_tpu/ops/dcplook.py``).

A DCP input profile applies in two stages: its matrices and HueSatMap
at the colour-space conversion (`color/dcp.py::apply_dcp`), its look
table, tone curve and baseline exposure inside the op chain, at the head
of stage 2 with `icm.dcp_look_early` (improcfun.cc:590-592), else in
stage 3 between saturation and the film simulation (:614-620). The
planner leaves step 2's static and arrays in ``ctx["dcp_step2"]``; this
op places them in the chain.
"""

from __future__ import annotations


def _plan(pp, ctx, early: bool):
    step2 = ctx.get("dcp_step2")
    if step2 is None or bool(pp.icm.dcp_look_early) != early:
        return None
    return step2


def plan_early(pp, ctx):
    return _plan(pp, ctx, True)


def plan_late(pp, ctx):
    return _plan(pp, ctx, False)


plan = plan_late


def apply(rgb, data, static):
    from art_tpu_torch.color.dcp import apply_dcp_look

    return apply_dcp_look(rgb, data, static)
