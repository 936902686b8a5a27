"""`PrivacyPool.verify_vouchers_batch` over batches of the config's
voucher_batch, closed loop.

Set-up signs `batches` batches with the pool's sequencer key through the
port's `eddsa_sign_batch` (seeded nonces and bindings) and tampers
`tampered` seeded vouchers of each: the message, s, R swapped with another
voucher's, R off the curve, or s + the subgroup order (which stays valid).
Every verdict of every call is compared with the reference's
(reference/eddsa.py), which also gives the challenge scalars the ladder's
least work is counted from."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .. import work
from ..reference import eddsa, field

CONTROL_FAULTS = ("control", "half_batch", "answer_altered")
TAMPER = ("message", "s", "r_swap", "r_off_curve", "s_plus_suborder")


def program(ctx):
    if ctx.program is not None:
        return ctx.program
    from owshen_tpu_torch.curves.babyjubjub import eddsa_sign_batch
    from owshen_tpu_torch.protocol.pool import PrivacyPool, Voucher

    return SimpleNamespace(PrivacyPool=PrivacyPool, Voucher=Voucher,
                           eddsa_sign_batch=eddsa_sign_batch)


def tamper(v, kind: str, other):
    if kind == "message":
        v.binding += 1
    elif kind == "s":
        v.sig_s += 1
    elif kind == "r_swap":
        v.sig_r = other.sig_r
    elif kind == "r_off_curve":
        v.sig_r = (v.sig_r[0], (v.sig_r[1] + 1) % field.P_FR)
    elif kind == "s_plus_suborder":
        v.sig_s += eddsa.SUBORDER


def setup(ctx):
    rng, t, n = ctx.rng, ctx.traffic, ctx.config["voucher_batch"]
    prog = program(ctx)
    secret = rng.randrange(1, eddsa.SUBORDER)
    pool = prog.PrivacyPool(depth=ctx.config["tree_depth"], seq_secret=secret,
                            setup_seed=b"benchmark-vouchers|%d" % ctx.seed, device=ctx.device)
    batches = []
    for _ in range(t["batches"]):
        bindings = [rng.getrandbits(256) for _ in range(n)]
        nonces = [rng.randrange(field.P_FR) for _ in range(n)]
        sigs = prog.eddsa_sign_batch([secret] * n, nonces, [b % field.P_FR for b in bindings],
                                     device=ctx.device)
        batch = [prog.Voucher(recipient=rng.getrandbits(160), amount=rng.randrange(1, 10 ** 21),
                              nullifier=rng.randrange(field.P_FR), binding=b, sig_r=r, sig_s=s)
                 for b, (r, s) in zip(bindings, sigs)]
        for k, pos in enumerate(rng.sample(range(n), t["tampered"])):
            tamper(batch[pos], TAMPER[k % len(TAMPER)], batch[(pos + 1) % n])
        batches.append(batch)
    signed = [[(v.binding, v.sig_r, v.sig_s) for v in b] for b in batches]
    if ctx.fault == "control":      # s cut to 248 bits: its top byte dropped
        batches = [[prog.Voucher(**{**v.__dict__, "sig_s": v.sig_s % (1 << 248)}) for v in b]
                   for b in batches]
    for w in range(t["warm_calls"]):
        pool.verify_vouchers_batch(batches[w % len(batches)])
    return {"units_per_op": n, "pool": pool, "batches": batches, "kept": [],
            "fault": ctx.fault, "signed": signed, "secret": secret}


def step(state, i):
    b = i % len(state["batches"])
    verdicts = np.asarray(state["pool"].verify_vouchers_batch(state["batches"][b]), dtype=bool)
    if state["fault"] == "half_batch":      # the second half left unchecked, taken as valid
        verdicts[len(verdicts) // 2:] = True
    if state["fault"] == "answer_altered":  # one verdict flipped where it is produced
        k = len(verdicts) // 3
        verdicts[k] = not verdicts[k]
    state["kept"].append((b, verdicts))
    return 1


def release(state):
    return {"secret": state["secret"], "signed": state["signed"], "kept": state["kept"]}


def check(out, ctx, pool):
    """Every verdict of every call against the reference's."""
    pub, chunk = eddsa.public_key(out["secret"]), 512
    ref, least = [], []
    for batch in out["signed"]:
        items = [(binding % field.P_FR, r, s) for binding, r, s in batch]
        parts = pool.map(_verify, [(pub, items[o:o + chunk]) for o in range(0, len(items), chunk)])
        res = [x for part in parts for x in part]
        ref.append(np.asarray([ok for ok, _ in res], dtype=bool))
        least.append(work.jub_ladder_s([h for _, h in res]))
    wrong = sum(int((verdicts != ref[b]).sum()) for b, verdicts in out["kept"])
    ctx.reading["ladder_least_s"] = sum(least[b] for b, _ in out["kept"])
    return [("verdicts_wrong", wrong, 0)]


def _verify(job):
    pub, items = job
    return eddsa.verify_many(pub, items)
