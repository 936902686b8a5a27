"""`PrivacyPool.prove_withdraw`, closed loop, one proof in flight: a relayer
proves withdrawals of distinct notes back to back.

Set-up builds a pool from a seeded setup seed and fills its depth-16 tree
with one `deposit` batch of `deposit_batch` commitments: `own_notes` of them
are seeded notes (secret, salt, amount, token) the window withdraws, in a
seeded order, the rest other users' commitments (seeded field elements).
Every proof's root and nullifier are compared with the reference's (the
tree's root over the deposited commitments, Poseidon(secret, index)), and a
seeded sample of `verified` proofs, the last among them, is checked by the
pairing against the verifying key worked out again from the setup seed
(reference/groth16.py)."""

from __future__ import annotations

from types import SimpleNamespace

from ..reference import field, groth16 as rg, poseidon

CONTROL_FAULTS = ("control", "answer_altered")


def program(ctx):
    if ctx.program is not None:
        return ctx.program
    from owshen_tpu_torch.protocol.pool import PrivacyPool

    return SimpleNamespace(PrivacyPool=PrivacyPool)


def setup(ctx):
    rng, t, depth = ctx.rng, ctx.traffic, ctx.config["tree_depth"]
    p = field.P_FR
    n_dep, n_own = t["deposit_batch"], t["own_notes"]
    tokens = [0] + [rng.getrandbits(160) for _ in range(t["tokens"] - 1)]
    at = rng.sample(range(n_dep), n_own)
    notes = [{"secret": rng.randrange(p), "salt": rng.randrange(p),
              "amount": rng.randrange(1, 10 ** 21), "token": rng.choice(tokens),
              "index": i, "recipient": rng.getrandbits(160)} for i in at]
    leaves = [rng.randrange(p) for _ in range(n_dep)]
    amounts = [rng.randrange(1, 10 ** 21) for _ in range(n_dep)]
    toks = [rng.choice(tokens) for _ in range(n_dep)]
    for note in notes:
        i = note["index"]
        leaves[i] = poseidon.poseidon([note["secret"], note["salt"], note["amount"],
                                       note["token"]])
        amounts[i], toks[i] = note["amount"], note["token"]
    txs = [rng.getrandbits(256) for _ in range(n_dep)]
    setup_seed = b"benchmark-withdraw|%d" % ctx.seed
    pool = program(ctx).PrivacyPool(depth=depth, setup_seed=setup_seed, device=ctx.device)
    pool.deposit(leaves, txs, amounts, toks)
    state = {"units_per_op": 1, "pool": pool, "notes": notes, "kept": [], "fault": ctx.fault,
             "leaves": leaves, "setup_seed": setup_seed, "depth": depth,
             "sample_seed": rng.getrandbits(64)}
    for w in range(t["warm_calls"]):
        _prove(state, notes[-1 - w], notes[-1 - w]["recipient"])
    return state


def _prove(state, note, recipient):
    return state["pool"].prove_withdraw(note["secret"], note["salt"], note["amount"],
                                        note["index"], recipient, token=note["token"])


def step(state, i):
    note = state["notes"][i % len(state["notes"])]
    recipient = note["recipient"]
    if state["fault"] == "control":     # the proof bound to another recipient
        recipient ^= 1
    proof, root, nullifier = _prove(state, note, recipient)
    a, b, c = proof.a, proof.b, proof.c
    if state["fault"] == "answer_altered":   # C altered where it is produced
        c = rg.curve.G1.add(c, rg.curve.G1_GEN)
    state["kept"].append((i % len(state["notes"]), (a, b, c), root, nullifier))
    return 1


def release(state):
    return {k: state[k] for k in ("notes", "kept", "leaves", "setup_seed", "depth",
                                  "sample_seed")}


def _key(job):
    depth, seed = job
    return rg.verifying_key(rg.withdraw_shape(depth), seed)


def _root(job):
    leaves, depth = job
    return poseidon.sparse_root(dict(enumerate(leaves)), depth)


def _verify(job):
    key, publics, proof = job
    return rg.verify(key, publics, *proof)


def check(out, ctx, pool):
    import random

    key_f = pool.submit(_key, (out["depth"], out["setup_seed"]))
    root_f = pool.submit(_root, (out["leaves"], out["depth"]))
    kept, notes = out["kept"], out["notes"]
    want_null = {k: poseidon.poseidon([notes[k]["secret"], notes[k]["index"]])
                 for k in {k for k, *_ in kept}}
    root = root_f.result()
    publics_wrong = sum((r != root) + (nul != want_null[k]) for k, _, r, nul in kept)
    n = min(ctx.traffic["verified"], len(kept))
    picks = sorted(random.Random(out["sample_seed"]).sample(range(len(kept) - 1), n - 1)
                   + [len(kept) - 1]) if kept else []
    key = key_f.result()
    jobs = []
    for j in picks:
        k, proof, _, _ = kept[j]
        note = notes[k]
        publics = [root, want_null[k], note["recipient"], note["amount"], note["token"]]
        jobs.append((key, publics, proof))
    rejected = sum(not ok for ok in pool.map(_verify, jobs))
    return [("proofs_rejected", rejected, 0), ("publics_wrong", publics_wrong, 0)]
