"""Privacy-pool circuits: the deposit commitment and the withdraw
membership proof.

These are the circuits the original Owshen wallet delegates to circom —
absent from the reference snapshot (SURVEY.md §0), whose on-chain skeleton
nonetheless fixes their semantics:

  * deposit → Mint credits a commitment into the pool
    (reference: src/blockchain/tx/mint_tx.rs:11-49, double-spend guards on
    the deposited-tx hash),
  * withdraw → Burn debits against a replay-protected burn id
    (reference: src/blockchain/tx/burn_tx.rs:11-32 and the `isExecuted[id]`
    guard in contracts/src/Owshen.sol:66-78).

The deposit circuit binds a commitment to hidden (secret, salt); the
withdraw circuit proves membership of such a commitment under the pool's
Merkle root and exposes a deterministic nullifier — the circuit-level
burn_id — plus binds the recipient so a voucher cannot be front-run.  The
hash is the Poseidon of ops/hash.py (identical constants => in-circuit and
on-card values match bit-exactly).  As in the reference, the pool's
deposit path proves nothing: a deposit proof is the wallet's to make.

Each circuit is written once, over a builder: `*_circuit` runs it on a
`Builder` (the structure, with the values when a witness is given), and
`*_values` on a `WitnessBuilder` (the values only, for a proof on a key
that keeps the structure).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..groth16.r1cs import Builder, WitnessBuilder
from ..oracle import hash as ohash
from .gadgets import merkle_path_gadget, poseidon_gadget


def commitment_of(secret: int, salt: int, amount: int, token: int = 0) -> int:
    """Host-side commitment (must equal the in-circuit value).

    `token` is the asset id (0 = native, otherwise the ERC20 address as an
    integer — reference Token::{Native, Erc20{address,..}},
    src/types/tx/custom.rs:31-93).  Binding the token INTO the commitment
    makes the pool multi-asset end to end: a withdrawal proof can only
    release the asset the deposit escrowed (the L1 hash binds the token
    the same way, contracts/src/Owshen.sol:70)."""
    return ohash.poseidon([secret, salt, amount, token])


def nullifier_of(secret: int, index: int) -> int:
    """Host-side nullifier — the replay guard (burn_id analogue)."""
    return ohash.poseidon([secret, index])


@dataclass
class DepositWitness:
    secret: int
    salt: int
    amount: int
    token: int = 0


def deposit_circuit(w: DepositWitness | None = None) -> Builder:
    """Public: [commitment, amount, token].  Proves knowledge of
    (secret, salt) with commitment = Poseidon(secret, salt, amount, token)."""
    return _deposit(Builder(), w)


def deposit_values(w: DepositWitness) -> WitnessBuilder:
    """The witness of `deposit_circuit(w)`, by the values-only pass."""
    return _deposit(WitnessBuilder(), w)


def _deposit(b: Builder, w: DepositWitness | None) -> Builder:
    have = w is not None
    com_v = commitment_of(w.secret, w.salt, w.amount, w.token) if have else None
    com = b.pub(com_v)
    amount = b.pub(w.amount if have else None)
    token = b.pub(w.token if have else None)
    secret = b.priv(w.secret if have else None)
    salt = b.priv(w.salt if have else None)
    out = poseidon_gadget(b, [secret, salt, amount, token])
    b.enforce_eq(out, com)
    return b


@dataclass
class WithdrawWitness:
    secret: int
    salt: int
    amount: int
    index: int            # leaf position of the commitment
    siblings: list[int]   # authentication path (bottom-up)
    token: int = 0        # asset id (0 = native; else ERC20 address int)


def withdraw_circuit(depth: int, w: WithdrawWitness | None = None,
                     root: int | None = None, recipient: int | None = None
                     ) -> Builder:
    """Public: [root, nullifier, recipient, amount, token].  Proves:
       commitment = Poseidon(secret, salt, amount, token) is in the tree at
       `index` under `root`; nullifier = Poseidon(secret, index).
    `recipient` is bound into the statement (squared into a constraint) so
    the proof is non-malleable toward a different payee — the ZK analogue of
    the voucher binding keccak256(abi.encode(msg.sender, ...)) in
    contracts/src/Owshen.sol:70-73.  `token` rides the commitment hash, so
    a proof can only release the deposited asset (the reference binds the
    token the same way: `_tokenAddress` in the Owshen.sol:70 hash and
    Token in every Mint/Burn, custom.rs:31-93)."""
    return _withdraw(Builder(), depth, w, root, recipient)


def withdraw_values(depth: int, w: WithdrawWitness, root: int,
                    recipient: int) -> WitnessBuilder:
    """The witness of `withdraw_circuit(depth, w, root, recipient)`, by the
    values-only pass."""
    return _withdraw(WitnessBuilder(), depth, w, root, recipient)


def _withdraw(b: Builder, depth: int, w: WithdrawWitness | None, root: int | None,
              recipient: int | None) -> Builder:
    have = w is not None
    null_v = nullifier_of(w.secret, w.index) if have else None
    root_lc = b.pub(root if root is not None else None)
    null_lc = b.pub(null_v)
    recip = b.pub(recipient)
    amount = b.pub(w.amount if have else None)
    token = b.pub(w.token if have else None)

    secret = b.priv(w.secret if have else None)
    salt = b.priv(w.salt if have else None)
    idx = b.priv(w.index if have else None)
    sibs = [b.priv(w.siblings[i] if have else None) for i in range(depth)]

    com = poseidon_gadget(b, [secret, salt, amount, token])
    bits = b.bits(idx, depth)
    computed_root = merkle_path_gadget(b, com, bits, sibs)
    b.enforce_eq(computed_root, root_lc)

    null_out = poseidon_gadget(b, [secret, idx])
    b.enforce_eq(null_out, null_lc)

    # bind recipient: recipient · recipient = recipient² (forces the public
    # input into the QAP so tampering invalidates the proof)
    b.mul(recip, recip)
    return b
