"""Canonical wire encoding for protocol messages (RLP tagged lists), a copy
of owshen_tpu/protocol/wire.py whose bytes equal the reference's.

The Owshen node defines byte-exact RLP codecs for its custom transactions —
tagged lists headed by a kind string, one arm per token type, with
round-trip + signer-recovery tests (Mint/Burn encodable/decodable at
src/types/tx/custom.rs:31-93,111-212,258-287 and src/types/tx/tests.rs).
This module is the port's equivalent: pure host code, a minimal,
dependency-free RLP (the subset the reference uses: byte strings
and lists) plus versioned codecs for the two protocol messages an external
verifier or L1 contract must consume:

  * ``Deposit``  — the Mint analogue: ["mint", v1, l1_tx_hash, commitment,
    token, amount]  (mint_tx.rs credits token+amount against the L1 hash);
  * ``Voucher``  — the Burn/withdrawal voucher: ["voucher", v1, recipient,
    token, amount, nullifier, chain_id, Rx, Ry, s] — the first five fields
    are exactly the Owshen.sol:70 binding tuple; the EdDSA signature (R, s)
    signs keccak256 of their abi.encode-style fixed-width concatenation
    (the contract's own hash), recomputed from the DECODED fields at
    verification time, so an encoded voucher can never carry release
    values that disagree with what was signed.

Integers encode big-endian with no leading zeros (canonical RLP ints);
decoding rejects non-canonical forms, trailing bytes, and unknown tags —
a consumer can never mis-parse a voucher into different release values.
"""

from __future__ import annotations

from ..fields.field import FR
from .pool import PoolError, Voucher

VERSION = 1


# ---------------------------------------------------------------------------
# Minimal canonical RLP (byte strings + lists)
# ---------------------------------------------------------------------------

def _enc_len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def rlp_encode(item) -> bytes:
    """item: bytes | int (non-negative) | str | list of items."""
    if isinstance(item, int):
        if item < 0:
            raise ValueError("RLP integers are non-negative")
        item = item.to_bytes((item.bit_length() + 7) // 8, "big") if item \
            else b""
    if isinstance(item, str):
        item = item.encode()
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _enc_len(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _enc_len(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item).__name__}")


def _dec_len(buf: bytes, pos: int, offset: int) -> tuple[int, int]:
    first = buf[pos] - offset
    if first < 56:
        return first, pos + 1
    nlen = first - 55
    if pos + 1 + nlen > len(buf):
        raise ValueError("RLP: truncated length")
    n = int.from_bytes(buf[pos + 1:pos + 1 + nlen], "big")
    if n < 56 or buf[pos + 1] == 0:
        raise ValueError("RLP: non-canonical length")
    return n, pos + 1 + nlen


def _decode_at(buf: bytes, pos: int):
    if pos >= len(buf):
        raise ValueError("RLP: truncated")
    b0 = buf[pos]
    if b0 < 0x80:
        return bytes([b0]), pos + 1
    if b0 < 0xC0:
        n, pos = _dec_len(buf, pos, 0x80)
        if pos + n > len(buf):
            raise ValueError("RLP: truncated string")
        s = buf[pos:pos + n]
        if n == 1 and s[0] < 0x80:
            raise ValueError("RLP: non-canonical single byte")
        return s, pos + n
    n, pos = _dec_len(buf, pos, 0xC0)
    end = pos + n
    if end > len(buf):
        raise ValueError("RLP: truncated list")
    out = []
    while pos < end:
        item, pos = _decode_at(buf, pos)
        out.append(item)
    if pos != end:
        raise ValueError("RLP: list payload overrun")
    return out, pos


def rlp_decode(buf: bytes):
    """Strict decode: rejects trailing bytes and non-canonical forms."""
    item, pos = _decode_at(bytes(buf), 0)
    if pos != len(buf):
        raise ValueError("RLP: trailing bytes")
    return item


def _as_int(b: bytes) -> int:
    if len(b) > 0 and b[0] == 0:
        raise ValueError("RLP: non-canonical integer (leading zero)")
    return int.from_bytes(b, "big")


# ---------------------------------------------------------------------------
# Protocol message codecs
# ---------------------------------------------------------------------------

def encode_deposit(l1_tx_hash: int, commitment: int, token: int,
                   amount: int) -> bytes:
    """The Mint analogue (custom.rs:31-93: tagged list, token arm encoded
    as its address int — 0 = native)."""
    return rlp_encode(["mint", VERSION, l1_tx_hash, commitment, token,
                       amount])


def decode_deposit(buf: bytes) -> dict:
    item = rlp_decode(buf)
    if not isinstance(item, list) or len(item) != 6:
        raise PoolError("malformed deposit encoding")
    tag, ver = item[0], _as_int(item[1])
    if tag != b"mint" or ver != VERSION:
        raise PoolError(f"unknown deposit tag/version {tag!r}/{ver}")
    return {
        "l1_tx_hash": _as_int(item[2]), "commitment": _as_int(item[3]),
        "token": _as_int(item[4]), "amount": _as_int(item[5]),
    }


def _binding_items(v: Voucher, chain_id: int) -> list:
    # field-for-field the Owshen.sol:70 abi.encode tuple order
    return [v.recipient, v.token, v.amount, v.nullifier, chain_id]


def encode_voucher(v: Voucher, chain_id: int) -> bytes:
    return rlp_encode(["voucher", VERSION, *_binding_items(v, chain_id),
                       v.sig_r[0], v.sig_r[1], v.sig_s])


def decode_voucher(buf: bytes) -> tuple[Voucher, int]:
    """Strict decode -> (Voucher, chain_id).  The binding hash is
    recomputed from the decoded fields (a voucher cannot carry a binding
    that disagrees with its own fields)."""
    item = rlp_decode(buf)
    if not isinstance(item, list) or len(item) != 10:
        raise PoolError("malformed voucher encoding")
    tag, ver = item[0], _as_int(item[1])
    if tag != b"voucher" or ver != VERSION:
        raise PoolError(f"unknown voucher tag/version {tag!r}/{ver}")
    recipient, token, amount, nullifier, chain_id, rx, ry, s = (
        _as_int(b) for b in item[2:10])
    from .pool import _binding_hash

    v = Voucher(recipient=recipient, amount=amount, nullifier=nullifier,
                token=token,
                binding=_binding_hash(recipient, token, amount, nullifier,
                                      chain_id),
                sig_r=(rx, ry), sig_s=s)
    return v, chain_id


def verify_voucher_bytes(buf: bytes, seq_pub, chain_id: int) -> Voucher:
    """Full consumer-side check of an encoded voucher: strict decode,
    chain-id match, and sequencer EdDSA signature over the binding —
    everything the L1 escrow's _processWithdraw does (Owshen.sol:66-78)
    except the isExecuted bookkeeping, which stays with the pool state."""
    from ..oracle import eddsa as oeddsa

    v, cid = decode_voucher(buf)
    if cid != chain_id:
        raise PoolError(f"voucher chain id {cid} != {chain_id}")
    if not oeddsa.verify(seq_pub, v.binding % FR.p, v.sig_r, v.sig_s):
        raise PoolError("bad sequencer signature")
    return v
