"""`ops.msm.msm(G1, points, scalars)` at n = 2^msm_log_n, closed loop.

The points are fixed, as a proving key's are: `distinct_points` seeded
consecutive multiples (k0 + j)·G, tiled to n.  Each call takes the next of
`scalar_sets` seeded sets of canonical scalars below r, made on the card in
set-up, as a new witness would.  Every call's point is compared with the
reference (reference/msm.py)."""

from __future__ import annotations

from types import SimpleNamespace

from .. import seeded
from ..reference import field, msm as rmsm

CONTROL_FAULTS = ("control", "half_batch", "answer_altered")


def program(ctx):
    if ctx.program is not None:
        return ctx.program
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.ops import msm

    return SimpleNamespace(msm=lambda pts, sc: msm.msm(bn254.G1, pts, sc))


def setup(ctx):
    import torch

    n = 1 << ctx.config["msm_log_n"]
    t = ctx.traffic
    count = t["distinct_points"]
    k0 = ctx.rng.randrange(1, field.P_FR - count)
    pts = rmsm.bases(k0, count)
    one = field.to_mont(1, field.P_FQ)
    cols = [[field.to_mont(p[0], field.P_FQ) for p in pts],
            [field.to_mont(p[1], field.P_FQ) for p in pts], [one] * count]
    points = tuple(torch.from_numpy(field.ints_to_rows(c)).to(ctx.device).repeat(n // count, 1)
                   for c in cols)
    gen = seeded.generator(torch, ctx.seed, ctx.device)
    scalars = seeded.field_rows(torch, gen, field.P_FR, (t["scalar_sets"], n), ctx.device)
    msm = program(ctx).msm
    for w in range(t["warm_calls"]):
        msm(points, scalars[w % t["scalar_sets"]])
    return {"units_per_op": n, "torch": torch, "msm": msm, "points": points,
            "scalars": scalars, "k0": k0, "count": count, "kept": [], "fault": ctx.fault}


def step(state, i):
    v = i % state["scalars"].shape[0]
    points, scalars, fault = state["points"], state["scalars"][v], state["fault"]
    if fault == "control":          # scalars cut to 240 bits: the top limb dropped
        scalars = scalars.clone()
        scalars[:, 15] = 0
    if fault == "half_batch":       # the second half of the points left out
        half = scalars.shape[0] // 2
        points = tuple(c[:half] for c in points)
        scalars = scalars[:half]
    out = state["msm"](points, scalars)
    if fault == "answer_altered":   # the result's X altered where it is produced
        out = (out[0].clone(), out[1], out[2])
        out[0][0] ^= 1
    state["kept"].append((v, out))
    return 1


def release(state):
    return {"torch": state["torch"], "scalars": state["scalars"], "k0": state["k0"],
            "count": state["count"],
            "kept": [(v, tuple(c.cpu() for c in out)) for v, out in state["kept"]]}


def check(out, ctx, pool):
    torch = out["torch"]
    want = {}
    wrong = 0
    for v, point in out["kept"]:
        if v not in want:
            want[v] = rmsm.expected(torch, out["scalars"][v], out["k0"], out["count"])
        wrong += rmsm.affine_of(point) != want[v]
    return [("msm_points_wrong", wrong, 0)]
