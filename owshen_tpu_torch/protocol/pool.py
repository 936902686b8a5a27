"""Privacy-pool protocol shell: the host-side state machine that ties the
card's kernels into the deposit / withdraw / redeem semantics of
owshen_tpu/protocol/pool.py.

  * deposit → Mint, with double-spend guards on the deposited L1 tx hash and
    the mint id (reference src/blockchain/tx/mint_tx.rs:17-34); the
    commitments go into the sparse Merkle tree on the card (K4);
  * withdraw → Burn: a Groth16 membership proof (proved on the card, checked
    by the host pairing) against a known root, released once per nullifier
    (burn_tx.rs:15-24, contracts/src/Owshen.sol:66-78) as a sequencer-signed
    voucher over keccak256(recipient, token, amount, id, chain id)
    (Owshen.sol:70-73);
  * redeem: the escrow's checks, once per voucher;
  * pop_batch: the reorg path, undoing the last deposit batch;
  * withdraw_batch / verify_vouchers_batch: the sequencer's batched paths,
    EdDSA over BabyJubJub on the card (curves/babyjubjub.py).

Checkpoints of a pool: runtime/checkpoint.py."""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..circuits import pool as circuits
from ..config import resolve_device, settings
from ..curves import babyjubjub as jub
from ..fields.field import FR, ints_to_tensor
from ..groth16 import groth16
from ..ops.keccak import keccak256_int
from ..ops.merkle import SparseMerkleTree
from ..oracle import eddsa as oeddsa
from ..runtime.metrics import metrics


class PoolError(Exception):
    pass


@dataclass(frozen=True)
class Token:
    """Asset identity (reference Token::{Native, Erc20{address, decimals,
    symbol}}, src/types/tx/custom.rs:31-93); circuits and vouchers bind
    `address` (0 = native) as the token id."""
    address: int = 0
    decimals: int = 18
    symbol: str = "ETH"

    @property
    def is_native(self) -> bool:
        return self.address == 0


NATIVE = Token()


def _token_id(token) -> int:
    return token.address if isinstance(token, Token) else int(token)


def _binding_hash(recipient: int, token: int, amount: int, nullifier: int,
                  chain_id: int) -> int:
    """keccak256(abi.encode(msg.sender, _tokenAddress, _amount, _id,
    block.chainid)) — contracts/src/Owshen.sol:70."""
    return keccak256_int(
        recipient.to_bytes(32, "big") + token.to_bytes(32, "big")
        + amount.to_bytes(32, "big") + nullifier.to_bytes(32, "big")
        + chain_id.to_bytes(32, "big"))


@dataclass
class Voucher:
    """L1-release material: the binding hash signed by the sequencer with
    EdDSA over BabyJubJub (Poseidon challenge hash), the binding reduced
    into Fr as the message."""
    recipient: int
    amount: int
    nullifier: int
    binding: int
    sig_r: tuple
    sig_s: int
    token: int = 0


class PrivacyPool:
    """Pool state = sparse Merkle tree of commitments on the card + host
    sets for nullifiers and the deposit guards."""

    def __init__(self, depth: int = 16, setup_seed: bytes = b"owshen-tpu-pool",
                 seq_secret: int | None = None, keys: tuple | None = None,
                 device=None):
        self.depth = depth
        self.device = resolve_device(device)
        self.tree = SparseMerkleTree(depth, device=self.device)
        self.next_index = 0
        self.deposited: set[int] = set()   # L1 tx hashes (mint_tx.rs:17-22)
        self.minted: set[int] = set()      # mint ids (mint_tx.rs:24-30)
        self.nullifiers: set[int] = set()  # burn ids (burn_tx.rs:15-18)
        self.executed: set[int] = set()    # L1-side isExecuted (Owshen.sol:68)
        # per-token escrow: a withdrawal may not exceed what was deposited
        # for its asset (burn_tx.rs:21-29)
        self.balances: dict[int, int] = {}
        self.roots: list[int] = [self.tree.root_int()]
        if seq_secret is None:
            seq_secret = keccak256_int(b"seq|" + setup_seed) % FR.p
        self._seq_priv = seq_secret
        self.seq_pub = oeddsa.to_pub(seq_secret)
        # per-batch inverse deltas (reference push_block / pop_block,
        # src/blockchain/mod.rs:284-315)
        self._undo: list[dict] = []
        if keys is None:
            keys = groth16.setup(circuits.withdraw_circuit(depth), seed=setup_seed,
                                 device=self.device)
        self.pk, self.vk = keys
        if self.pk.device != self.device:
            raise ValueError(f"proving key on {self.pk.device}, pool on {self.device}")

    # ------------------------------------------------------------------
    # deposit (L1 → pool): mint_tx.rs:11-49
    # ------------------------------------------------------------------

    def deposit(self, commitments: list[int], l1_tx_hashes: list[int],
                amounts: list[int] | None = None,
                tokens: list | None = None) -> list[int]:
        """Credit a batch of commitments; returns their leaf indices.  Each
        L1 tx hash mints once and each mint id once, within the batch too."""
        if len(commitments) != len(l1_tx_hashes):
            raise PoolError("commitments/tx_hashes length mismatch")
        amounts = [0] * len(commitments) if amounts is None else amounts
        tokens = [0] * len(commitments) if tokens is None else tokens
        if len(amounts) != len(commitments) or len(tokens) != len(commitments):
            raise PoolError("amounts/tokens length mismatch")
        token_ids = [_token_id(t) for t in tokens]
        mint_ids = []
        seen_tx: set[int] = set()
        seen_mid: set[int] = set()
        for com, txh in zip(commitments, l1_tx_hashes):
            if txh in self.deposited or txh in seen_tx:
                raise PoolError(f"tx {txh:#x} already deposited")
            mid = keccak256_int(txh.to_bytes(32, "big") + com.to_bytes(32, "big"))
            if mid in self.minted or mid in seen_mid:
                raise PoolError(f"mint {mid:#x} already applied")
            seen_tx.add(txh)
            seen_mid.add(mid)
            mint_ids.append(mid)
        idxs = list(range(self.next_index, self.next_index + len(commitments)))
        if idxs and idxs[-1] >= (1 << self.depth):
            raise PoolError("pool full")
        rows = self.tree.touched_rows(idxs)
        prior = self.tree.snapshot_rows(rows)
        with metrics.timer("pool.deposit_insert"):
            self.tree.insert_ints(idxs, commitments)
        metrics.inc("pool.deposits", len(commitments))
        self.next_index += len(commitments)
        metrics.gauge("pool.next_index", self.next_index)
        self.deposited.update(l1_tx_hashes)
        self.minted.update(mint_ids)
        for tid, amt in zip(token_ids, amounts):
            self.balances[tid] = self.balances.get(tid, 0) + amt
        self.roots.append(self.tree.root_int())
        self._undo.append({
            "rows": rows, "prior": prior, "count": len(commitments),
            "tx_hashes": list(l1_tx_hashes), "mint_ids": mint_ids,
            "amounts": list(amounts), "tokens": token_ids})
        return idxs

    def pop_batch(self) -> int:
        """Unwind the most recent deposit batch, the reorg path (reference
        pop_block replays the persisted inverse delta,
        src/blockchain/mod.rs:291-315): the tree rows get their prior
        values back, the batch's guards and credits are removed and the
        root history rewinds.  Returns the number of commitments unwound."""
        if not self._undo:
            raise PoolError("no batch to pop")
        rec = self._undo.pop()
        self.tree.restore_rows(rec["rows"], rec["prior"])
        self.next_index -= rec["count"]
        self.deposited.difference_update(rec["tx_hashes"])
        self.minted.difference_update(rec["mint_ids"])
        for tid, amt in zip(rec["tokens"], rec["amounts"]):
            self.balances[tid] = self.balances.get(tid, 0) - amt
        self.roots.pop()
        metrics.inc("pool.pops")
        if self.tree.root_int() != self.roots[-1]:
            raise AssertionError("rollback restored a different root")
        return rec["count"]

    # ------------------------------------------------------------------
    # withdraw (pool → L1 voucher): burn_tx.rs:11-32 + Owshen.sol:66-78
    # ------------------------------------------------------------------

    def withdraw(self, proof: groth16.Proof, root: int, nullifier: int,
                 recipient: int, amount: int, token=0) -> Voucher:
        """Verify a membership proof and release a voucher once per
        nullifier; per-token conservation is checked after the proof."""
        tid = _token_id(token)
        if root not in self.roots:
            raise PoolError("unknown root")
        if nullifier in self.nullifiers:
            raise PoolError("nullifier already spent")
        with metrics.timer("pool.withdraw_verify"):
            ok = groth16.verify(self.vk, [root, nullifier, recipient, amount, tid], proof)
        if not ok:
            metrics.inc("pool.rejected_proofs")
            raise PoolError("invalid proof")
        if self.balances.get(tid, 0) < amount:
            raise PoolError("insufficient pool balance")
        metrics.inc("pool.withdrawals")
        self.nullifiers.add(nullifier)
        self.balances[tid] = self.balances.get(tid, 0) - amount
        binding = _binding_hash(recipient, tid, amount, nullifier, settings().chain_id)
        R, s = oeddsa.sign(self._seq_priv,
                           int.from_bytes(os.urandom(32), "big") % FR.p,
                           binding % FR.p)
        return Voucher(recipient=recipient, amount=amount, token=tid,
                       nullifier=nullifier, binding=binding, sig_r=R, sig_s=s)

    # ------------------------------------------------------------------
    # L1-escrow side: redeem a voucher exactly once (Owshen.sol:66-78)
    # ------------------------------------------------------------------

    def redeem(self, voucher: Voucher) -> bool:
        if voucher.nullifier in self.executed:
            raise PoolError("voucher already executed")
        binding = _binding_hash(voucher.recipient, voucher.token, voucher.amount,
                                voucher.nullifier, settings().chain_id)
        if binding != voucher.binding:
            raise PoolError("binding mismatch")
        if not oeddsa.verify(self.seq_pub, binding % FR.p, voucher.sig_r, voucher.sig_s):
            raise PoolError("bad sequencer signature")
        self.executed.add(voucher.nullifier)
        return True

    def verify_vouchers_batch(self, vouchers: list[Voucher]):
        """Batched EdDSA check of vouchers against the sequencer key on the
        pool's device (reference analogue: the per-tx signature checks of
        apply_tx, mod.rs:99-115).  Returns a numpy bool[n]; no replay
        accounting."""
        n, dev = len(vouchers), self.device
        ax = FR.encode([self.seq_pub[0]] * n, device=dev)
        ay = FR.encode([self.seq_pub[1]] * n, device=dev)
        rx = FR.encode([v.sig_r[0] for v in vouchers], device=dev)
        ry = FR.encode([v.sig_r[1] for v in vouchers], device=dev)
        msg = FR.encode([v.binding % FR.p for v in vouchers], device=dev)
        s = ints_to_tensor([v.sig_s for v in vouchers], dev)     # raw limbs: s may exceed p
        return jub.eddsa_verify((ax, ay), msg, (rx, ry), s).cpu().numpy()

    def withdraw_batch(self, requests: list[tuple]) -> list[Voucher]:
        """Batched withdrawal: each request passes the single path's guards
        and proof check in turn, then ONE batched EdDSA sign on the pool's
        device issues all the vouchers.  requests: [(proof, root, nullifier,
        recipient, amount[, token])].  Raises on the first invalid request
        and changes no state unless all pass (the batch analogue of apply_tx
        failing the block)."""
        norm = []
        for req in requests:
            proof, root, nullifier, recipient, amount = req[:5]
            tid = _token_id(req[5]) if len(req) > 5 else 0
            norm.append((proof, root, nullifier, recipient, amount, tid))
        bindings = []
        # the reference applies burns one at a time, so a nullifier repeated
        # within a batch fails like a replay (burn_tx.rs:17-18), and the
        # running per-token debit must stay covered (burn_tx.rs:21-24)
        seen_nullifiers: set[int] = set()
        debits: dict[int, int] = {}
        for proof, root, nullifier, recipient, amount, tid in norm:
            if root not in self.roots:
                raise PoolError("unknown root")
            if nullifier in self.nullifiers or nullifier in seen_nullifiers:
                raise PoolError("nullifier already spent")
            seen_nullifiers.add(nullifier)
            if not groth16.verify(self.vk, [root, nullifier, recipient, amount, tid], proof):
                metrics.inc("pool.rejected_proofs")
                raise PoolError("invalid proof")
            debited = debits.get(tid, 0) + amount
            if self.balances.get(tid, 0) < debited:
                raise PoolError("insufficient pool balance")
            debits[tid] = debited
            bindings.append(_binding_hash(recipient, tid, amount, nullifier,
                                          settings().chain_id))
        n = len(norm)
        sigs = jub.eddsa_sign_batch(
            [self._seq_priv] * n,
            [int.from_bytes(os.urandom(32), "big") % FR.p for _ in range(n)],
            [b % FR.p for b in bindings], device=self.device)
        out = []
        for (_, _, nullifier, recipient, amount, tid), binding, (R, s) in zip(
                norm, bindings, sigs):
            self.nullifiers.add(nullifier)
            self.balances[tid] = self.balances.get(tid, 0) - amount
            metrics.inc("pool.withdrawals")
            out.append(Voucher(recipient=recipient, amount=amount, token=tid,
                               nullifier=nullifier, binding=binding, sig_r=R, sig_s=s))
        return out

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    def prove_withdraw(self, secret: int, salt: int, amount: int, index: int,
                       recipient: int, msm_c: int = 8, msm_lanes: int = 256,
                       token=0, *, seed: bytes | None = None
                       ) -> tuple[groth16.Proof, int, int]:
        """Build the witness from the live tree and prove membership on the
        pool's device.  Returns (proof, root, nullifier).  The parameters
        before `seed` are the reference's, in its order; `msm_c` and
        `msm_lanes` go to `groth16.prove`.  `seed` fixes the proof's
        randomizers (tests only)."""
        sibs_dev, _bits = self.tree.path([index])
        sibs = FR.decode(sibs_dev[0])
        w = circuits.WithdrawWitness(secret=secret, salt=salt, amount=amount,
                                     index=index, siblings=sibs, token=_token_id(token))
        root = self.tree.root_int()
        b = circuits.withdraw_circuit(self.depth, w, root=root, recipient=recipient)
        if not b.check():
            raise PoolError("witness does not satisfy the circuit")
        with metrics.timer("pool.prove_withdraw"):
            proof = groth16.prove(self.pk, b, seed=seed, msm_c=msm_c,
                                  msm_lanes=msm_lanes, device=self.device)
        return proof, root, circuits.nullifier_of(secret, index)
