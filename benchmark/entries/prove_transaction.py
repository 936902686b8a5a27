"""`UtxoPool.prove_transaction`, closed loop, one proof in flight: a relayer
proves `n_ins`-input, `n_outs`-output joinsplits back to back.

Set-up builds a pool from a seeded setup seed and fills its tree through
the deposit path with `deposit_batches` batches of `deposit_batch`
commitments: `users` seeded users own `n_ins` notes each, at seeded
leaves, with amounts in [1, max_amount]; the other leaves are seeded field
elements.  Transaction k spends every note of user k mod `users`: an even
k is a transfer (publicAmount 0), an odd one withdraws a seeded extAmount
in [1, Σ in] (publicAmount p − extAmount); the outputs split what is left
at a seeded point, to seeded public keys and blindings, and extDataHash is
a seeded field element.  Each transaction is drawn from its own seed, so
the check draws it again.

Every proof's publics (root, publicAmount, extDataHash, the nullifiers and
the output commitments) are compared with the reference's
(reference/transaction.py), and every proof is checked by the pairing
against the verifying key worked out again from the setup seed over the
reference's own shape of the circuit."""

from __future__ import annotations

import random
from types import SimpleNamespace

from ..reference import field, groth16 as rg, poseidon, transaction as rt

CONTROL_FAULTS = ("control", "answer_altered")
CHUNK_LEAVES = 2048     # leaves a worker hashes for the reference root


def program(ctx):
    if ctx.program is not None:
        return ctx.program
    from owshen_tpu_torch.protocol.utxo import UtxoPool

    return SimpleNamespace(UtxoPool=UtxoPool)


def setup(ctx):
    make_pool = program(ctx).UtxoPool
    rng, t, cfg = ctx.rng, ctx.traffic, ctx.config
    p = field.P_FR
    levels, n_ins, n_outs = cfg["levels"], cfg["n_ins"], cfg["n_outs"]
    n_leaves = t["deposit_batches"] * t["deposit_batch"]
    at = rng.sample(range(n_leaves), t["users"] * n_ins)
    keys = [rng.randrange(1, p) for _ in range(t["users"])]
    notes = [(rng.randrange(1, t["max_amount"] + 1), keys[u], rng.randrange(p), at[u * n_ins + j])
             for u in range(t["users"]) for j in range(n_ins)]
    leaves = [rng.randrange(p) for _ in range(n_leaves)]
    amounts = [rng.randrange(1, t["max_amount"] + 1) for _ in range(n_leaves)]
    for amount, key, blinding, index in notes:
        leaves[index] = rt.commitment(amount, rt.public_key(key), blinding)
        amounts[index] = amount
    txs = [rng.getrandbits(256) for _ in range(n_leaves)]
    setup_seed = b"benchmark-transaction|%d" % ctx.seed
    pool = make_pool(levels=levels, n_ins=n_ins, n_outs=n_outs, setup_seed=setup_seed,
                     device=ctx.device)
    b = t["deposit_batch"]
    for k in range(t["deposit_batches"]):
        pool.deposit(leaves[k * b:(k + 1) * b], txs[k * b:(k + 1) * b], amounts[k * b:(k + 1) * b])
    state = {"units_per_op": 1, "pool": pool, "kept": [], "fault": ctx.fault,
             "shape": (levels, n_ins, n_outs), "notes": notes, "leaves": leaves,
             "setup_seed": setup_seed, "tx_seed": rng.getrandbits(64)}
    for w in range(t["warm_calls"]):
        _prove(state, transaction(state, -1 - w))
    return state


def transaction(state, k: int) -> dict:
    """Transaction k of the run: spends user k mod users' notes."""
    _, n_ins, n_outs = state["shape"]
    p = field.P_FR
    rng = random.Random(f"{state['tx_seed']}|{k}")
    u = k % (len(state["notes"]) // n_ins)
    inputs = state["notes"][u * n_ins:(u + 1) * n_ins]
    total = sum(x[0] for x in inputs)
    ext = 0 if k % 2 == 0 else rng.randint(1, total)
    left = total - ext
    cuts = sorted(rng.randint(0, left) for _ in range(n_outs - 1))
    shares = [b - a for a, b in zip([0] + cuts, cuts + [left])]
    outputs = [(a, rng.randrange(p), rng.randrange(p)) for a in shares]
    return {"inputs": inputs, "outputs": outputs, "public_amount": (p - ext) % p,
            "ext_data_hash": rng.randrange(p)}


def _prove(state, tx, ext_data_hash=None):
    return state["pool"].prove_transaction(
        tx["inputs"], tx["outputs"], tx["public_amount"],
        tx["ext_data_hash"] if ext_data_hash is None else ext_data_hash)


def step(state, i):
    tx = transaction(state, i)
    ext = tx["ext_data_hash"]
    if state["fault"] == "control":     # the proof bound to other external data
        ext ^= 1
    proof, publics = _prove(state, tx, ext)
    a, b, c = proof.a, proof.b, proof.c
    if state["fault"] == "answer_altered":   # C altered where it is produced
        c = rg.curve.G1.add(c, rg.curve.G1_GEN)
    state["kept"].append((i, (a, b, c), list(publics)))
    return 1


def release(state):
    return {k: state[k] for k in ("kept", "shape", "notes", "leaves", "setup_seed", "tx_seed")}


def _key(job):
    shape, seed = job
    return rg.verifying_key(rt.transaction_shape(*shape), seed)


def _chunk_root(job):
    leaves, height = job
    return poseidon.sparse_root(dict(enumerate(leaves)), height)


def _verify(job):
    key, publics, proof = job
    return rg.verify(key, publics, *proof)


def check(out, ctx, pool):
    levels = out["shape"][0]
    key_f = pool.submit(_key, (out["shape"], out["setup_seed"]))
    leaves = out["leaves"]
    step_ = min(CHUNK_LEAVES, 1 << levels)
    height = step_.bit_length() - 1
    chunks = [leaves[i:i + step_] for i in range(0, len(leaves), step_)]
    roots = pool.map(_chunk_root, [(c, height) for c in chunks])
    root = rt.root_above(dict(enumerate(roots)), height, levels)
    state = {"shape": out["shape"], "notes": out["notes"], "tx_seed": out["tx_seed"]}
    kept, publics_wrong, jobs = out["kept"], 0, []
    key = key_f.result()
    for k, proof, got in kept:
        tx = transaction(state, k)
        want = rt.publics(root, tx["public_amount"], tx["ext_data_hash"], tx["inputs"],
                          tx["outputs"])
        publics_wrong += sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))
        jobs.append((key, want, proof))
    rejected = sum(not ok for ok in pool.map(_verify, jobs))
    return [("proofs_rejected", rejected, 0), ("publics_wrong", publics_wrong, 0)]
