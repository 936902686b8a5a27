"""A Tornado Cash Nova-style shielded UTXO pool (tornado-nova's
`TornadoPool.transact`): notes are commitments in a height-`levels`
Poseidon tree on the card, and one joinsplit proof spends `n_ins` of them
and creates `n_outs` (circuits/transaction.py).

  * deposit: `CommitmentPool.deposit`, shared with `PrivacyPool` (the L1
    guards, the credits, the root history and the undo log);
  * prove_transaction: the client's side, one batched `tree.path` for every
    input, the values-only witness checked against the rows the proving
    key keeps, and `groth16.prove` on the pool's device;
  * transact: the pool's side, a known root, fresh and pairwise-distinct
    nullifiers and the pairing, then the nullifiers spent and the output
    commitments appended to the tree as one batch `pop_batch` can undo.

A key of the published shape (levels 23, 16 inputs, 2 outputs: ~108k
constraints, a 2^17 domain) needs ~87 GB of fixed prover tables, more
than the card's budget, so `groth16.prove` sends it to the sorted
Pippenger engine by the rule every key follows."""

from __future__ import annotations

from ..circuits import transaction
from ..fields.field import FR
from ..groth16 import groth16
from ..oracle.field import P_FR
from ..runtime.metrics import metrics
from .pool import CommitmentPool, PoolError

MAX_EXT_AMOUNT = 1 << 248     # TornadoPool.MAX_EXT_AMOUNT


class UtxoPool(CommitmentPool):
    """Pool state = the commitment tree on the card, the spent nullifiers,
    the deposit guards and the pool's balance of its one asset (token 0)."""

    def __init__(self, levels: int = 23, n_ins: int = 16, n_outs: int = 2,
                 setup_seed: bytes = b"owshen-tpu-utxo", keys: tuple | None = None,
                 device=None):
        super().__init__(levels, device)
        self.n_ins, self.n_outs = n_ins, n_outs
        if keys is None:
            keys = groth16.setup(transaction.transaction_circuit(levels, n_ins, n_outs),
                                 seed=setup_seed, device=self.device)
        self.pk, self.vk = keys
        if self.pk.device != self.device:
            raise ValueError(f"proving key on {self.pk.device}, pool on {self.device}")

    def prove_transaction(self, inputs, outputs, public_amount: int, ext_data_hash: int,
                          *, seed: bytes | None = None) -> tuple[groth16.Proof, list[int]]:
        """Prove that `inputs` (TxInput or (amount, private_key, blinding,
        index) each) are notes under the tree's root and `outputs` (TxOutput
        or (amount, pubkey, blinding)) balance them with `public_amount`
        (the external amount less the fee, mod p).  Returns (proof,
        publics), the publics in the circuit's order.  `seed` fixes the
        proof's randomizers (tests only).

        Timed as the span `pool.prove_request`, with one child span a stage:
        `pool.tree_path` (one `tree.path` for every input), `pool.synthesize`,
        `pool.check` and `pool.prove_transaction` (`groth16.prove`)."""
        inputs = [transaction.TxInput(*x) for x in inputs]
        outputs = [transaction.TxOutput(*x) for x in outputs]
        with metrics.timer("pool.prove_request"):
            with metrics.timer("pool.tree_path"):
                sibs_dev, _bits = self.tree.path([x.index for x in inputs])
                sibs = FR.decode(sibs_dev.reshape(-1, FR.L))
                root = self.tree.root_int()
            paths = [sibs[i * self.depth:(i + 1) * self.depth] for i in range(len(inputs))]
            w = transaction.TransactionWitness(root, public_amount % P_FR,
                                               ext_data_hash % P_FR, inputs, paths, outputs)
            shape = (self.depth, self.n_ins, self.n_outs)
            b, proof = self._prove_on_key(lambda: transaction.transaction_values(*shape, w),
                                          lambda: transaction.transaction_circuit(*shape, w),
                                          "pool.prove_transaction", seed=seed)
        return proof, b.witness()[1:b.n_pub + 1]

    def transact(self, proof: groth16.Proof, publics: list[int]) -> list[int]:
        """Accept a transaction: its root is one the tree had, its
        nullifiers are distinct and unspent, its public amount is an
        external amount below 2^248 either way that the pool's balance
        covers, and its proof verifies.  Then the nullifiers are spent and
        the output commitments appended; returns their leaves."""
        n_ins = self.n_ins
        if len(publics) != 3 + n_ins + self.n_outs:
            raise PoolError(f"expected {3 + n_ins + self.n_outs} publics, got {len(publics)}")
        root, public_amount = publics[:2]
        nullifiers, outputs = list(publics[3:3 + n_ins]), list(publics[3 + n_ins:])
        if root not in self.roots:
            raise PoolError("unknown root")
        if len(set(nullifiers)) != n_ins:
            raise PoolError("repeated nullifier")
        if any(x in self.nullifiers for x in nullifiers):
            raise PoolError("nullifier already spent")
        ext_amount = public_amount if public_amount <= P_FR // 2 else public_amount - P_FR
        if abs(ext_amount) >= MAX_EXT_AMOUNT:
            raise PoolError("public amount out of range")
        if self.balances.get(0, 0) + ext_amount < 0:
            raise PoolError("insufficient pool balance")
        with metrics.timer("pool.transact_verify"):
            ok = groth16.verify(self.vk, list(publics), proof)
        if not ok:
            metrics.inc("pool.rejected_proofs")
            raise PoolError("invalid proof")
        idxs = self._append(outputs, {"tx_hashes": [], "mint_ids": [], "amounts": [ext_amount],
                                      "tokens": [0], "nullifiers": nullifiers},
                            "pool.transact_insert")
        self.nullifiers.update(nullifiers)
        self.balances[0] = self.balances.get(0, 0) + ext_amount
        metrics.inc("pool.transactions")
        return idxs
