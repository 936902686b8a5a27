"""`NttDomain(log_n).ntt` then `.intt` on the default route, closed loop,
over a pool of seeded vectors, with no host sync between transforms.

A seeded sample of the loop's iterations (and its last) is kept: each
forward output is checked against its input by a random linear combination
(reference/ntt.py), each inverse output must equal the input row for row,
and every element of both must be canonical (below p)."""

from __future__ import annotations

from types import SimpleNamespace

from .. import seeded
from ..reference import field, ntt as rntt

CONTROL_FAULTS = ("control", "half_batch", "answer_altered")


def program(ctx):
    if ctx.program is not None:
        return ctx.program
    from owshen_tpu_torch.ops.ntt import NttDomain

    return SimpleNamespace(domain=lambda log_n, device: NttDomain(log_n, device=device))


def setup(ctx):
    import torch

    log_n = ctx.config["ntt_log_n"]
    t = ctx.traffic
    gen = seeded.generator(torch, ctx.seed, ctx.device)
    xs = seeded.field_rows(torch, gen, field.P_FR, (t["vectors"], 1 << log_n), ctx.device)
    dom = program(ctx).domain(log_n, ctx.device)
    for _ in range(t["warm_calls"]):
        dom.intt(dom.ntt(xs[0]))
    sample = set(ctx.rng.sample(range(t["sample_from"]), t["sampled"]))
    return {"units_per_op": 1 << log_n, "torch": torch, "dom": dom, "xs": xs,
            "sample": sample, "kept": {}, "last": None, "fault": ctx.fault, "log_n": log_n,
            "rho": ctx.rng.randrange(2, field.P_FR)}


def _faulty(state, y):
    torch, fault = state["torch"], state["fault"]
    if fault == "control":          # lazy reduction: p added to every element
        p = torch.tensor(field.ints_to_rows([field.P_FR])[0], device=y.device)
        y = y.to(torch.int64) + p.to(torch.int64)
        for limb in range(15):
            carry = y[..., limb] >> 16
            y[..., limb] &= 0xFFFF
            y[..., limb + 1] += carry
        return y.to(torch.int32)
    if fault == "half_batch":       # the second half of the vector left out
        y = y.clone()
        y[y.shape[0] // 2:] = 0
    if fault == "answer_altered":   # one element altered where it is produced
        y = y.clone()
        y[7, 0] ^= 1
    return y


def step(state, i):
    x = state["xs"][i % state["xs"].shape[0]]
    dom = state["dom"]
    y = dom.ntt(x)
    if state["fault"]:
        y = _faulty(state, y)
    z = dom.intt(y)
    if i in state["sample"]:
        state["kept"][i] = (i % state["xs"].shape[0], y, z)
    state["last"] = (i, i % state["xs"].shape[0], y, z)
    return 2


def release(state):
    i, v, y, z = state["last"]
    kept = dict(state["kept"])
    kept[i] = (v, y, z)
    return {"xs": state["xs"], "kept": kept, "log_n": state["log_n"], "rho": state["rho"],
            "torch": state["torch"]}


def check(out, ctx, pool):
    torch = out["torch"]
    p_row = torch.tensor(field.ints_to_rows([field.P_FR])[0], device=out["xs"].device)
    wrong = non_canonical = 0
    omega = field.root_of_unity(out["log_n"])
    for _, (v, y, z) in sorted(out["kept"].items()):
        x = out["xs"][v]
        for rows in (y, z):
            # rows ≥ p: compare limbs from the top, lexicographically
            diff = rows.to(torch.int64) - p_row.to(torch.int64)
            nz = diff != 0
            top = torch.where(nz.any(-1), 15 - nz.flip(-1).to(torch.int8).argmax(-1), 0)
            lead = diff.gather(-1, top.unsqueeze(-1)).squeeze(-1)
            non_canonical += int((lead >= 0).sum())
        raw = lambda t: t.to(torch.int64).cpu().numpy().astype("<u2").tobytes()  # noqa: E731
        ok_y = rntt.is_ntt(raw(x), raw(y), out["log_n"], omega, out["rho"], pool)
        ok_z = bool(torch.equal(z, x))
        wrong += (not ok_y) + (not ok_z)
    return [("transforms_wrong", wrong, 0), ("non_canonical", non_canonical, 0)]
