"""Message Stream Encryption (MSE / BitTorrent protocol encryption).

The reference's anacrolix client speaks MSE out of the box (its
Config.HeaderObfuscationPolicy / "protocol encryption"; torrent.go:44
builds the default client, which accepts and initiates obfuscated
connections) — many real swarms refuse plaintext entirely. This module
implements the spec directly on stdlib + a small native RC4:

- Diffie-Hellman key exchange over the spec's 768-bit prime (96-byte
  public keys, 0-512 bytes of random padding each way),
- stream sync via SHA-1 markers (``HASH('req1', S)`` receiver-side,
  the RC4-encrypted verification constant initiator-side),
- torrent selection by ``HASH('req2', SKEY) xor HASH('req3', S)``
  (SKEY = info-hash),
- RC4-drop1024 payload encryption with per-direction keys
  (``HASH('keyA'|'keyB', S, SKEY)``), with plaintext selection also
  supported via the crypto_provide/crypto_select negotiation.

The RC4 keystream is the hot path (every payload byte); rc4_native.py
provides a lazily-compiled C implementation with a pure-Python
fallback, and both are cross-checked in tests against RFC 6229 vectors.

MSE is an obfuscation layer, not confidentiality: RC4 with an
unauthenticated DH is trivially MITM-able and that is the spec's
explicit, accepted design goal (defeating naive traffic shaping).
"""

from __future__ import annotations

import hashlib
import secrets
import socket
import struct

from .rc4_native import RC4

# the spec's 768-bit prime (P) and generator (G)
DH_PRIME = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A63A36210000000000090563",
    16,
)
DH_GENERATOR = 2
DH_KEY_BYTES = 96  # public keys travel as 96-byte big-endian

CRYPTO_PLAINTEXT = 0x01
CRYPTO_RC4 = 0x02

VC = b"\x00" * 8  # verification constant
MAX_PAD = 512
RC4_DROP = 1024

# receiver sync window: the initiator sends Ya(96) + PadA(<=512) before
# HASH('req1', S); initiator sync window: Yb(96) + PadB(<=512) before
# the encrypted VC(8)
_SYNC_WINDOW = DH_KEY_BYTES + MAX_PAD + 20


class MSEError(Exception):
    """Handshake failed: not an MSE peer, bad sync, or policy refusal."""


def _sha1(*parts: bytes) -> bytes:
    return hashlib.sha1(b"".join(parts)).digest()


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _keypair() -> tuple[int, bytes]:
    """(private, 96-byte public) per the spec's 160-bit private keys."""
    private = secrets.randbits(160) | 1
    public = pow(DH_GENERATOR, private, DH_PRIME)
    return private, public.to_bytes(DH_KEY_BYTES, "big")


def _secret(private: int, remote_public: bytes) -> bytes:
    remote = int.from_bytes(remote_public, "big")
    # 1 < Y < P-1 rejects the classic degenerate keys (0, 1, P-1) that
    # would force S into a tiny known set
    if not 1 < remote < DH_PRIME - 1:
        raise MSEError("degenerate remote DH public key")
    return pow(remote, private, DH_PRIME).to_bytes(DH_KEY_BYTES, "big")


def _pad() -> bytes:
    return secrets.token_bytes(secrets.randbelow(MAX_PAD + 1))


def _recv_exact(sock: socket.socket, count: int) -> bytes:  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)
    data = bytearray()
    while len(data) < count:
        chunk = sock.recv(count - len(data))
        if not chunk:
            raise MSEError("peer closed during MSE handshake")
        data += chunk
    return bytes(data)


def _sync_on(sock: socket.socket, marker: bytes, window: int, prefix: bytes) -> bytes:  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)
    """Read until ``marker`` is found within ``window`` bytes; returns
    the bytes that FOLLOW the marker (already-read surplus)."""
    buf = bytearray(prefix)
    while True:
        at = bytes(buf).find(marker)
        if at >= 0:
            return bytes(buf[at + len(marker) :])
        if len(buf) >= window:
            raise MSEError("MSE sync marker not found in window")
        chunk = sock.recv(4096)
        if not chunk:
            raise MSEError("peer closed during MSE sync")
        buf += chunk


class EncryptedSocket:
    """Duck-type of ``socket.socket`` for the peer wire paths: RC4 on
    both directions (or identity when a cipher is None — used to carry
    handshake-surplus bytes over a plaintext selection), with a small
    receive buffer for that surplus. ``fileno()`` exposes the real fd
    so readiness waits (SocketWaiter) and cancel hooks keep working on
    the underlying socket."""

    def __init__(
        self,
        sock: socket.socket,
        tx: "RC4 | None",
        rx: "RC4 | None",
        buffered: bytes = b"",
    ):
        self._sock = sock
        self._tx = tx
        self._rx = rx
        self._buf = bytearray(buffered)  # already decrypted

    def sendall(self, data: bytes) -> None:
        self._sock.sendall(self._tx.crypt(data) if self._tx is not None else data)

    def recv(self, count: int) -> bytes:
        if self._buf:
            take = bytes(self._buf[:count])
            del self._buf[:count]
            return take
        data = self._sock.recv(count)
        if data and self._rx is not None:
            return self._rx.crypt(data)
        return data

    def pending(self) -> int:
        """Decrypted-but-unread bytes; a readiness wait must check this
        before blocking on the fd."""
        return len(self._buf)

    def settimeout(self, value) -> None:
        self._sock.settimeout(value)

    def fileno(self) -> int:
        return self._sock.fileno()

    def close(self) -> None:
        self._sock.close()


def initiate(
    sock: socket.socket,
    info_hash: bytes,
    ia: bytes = b"",
    crypto_provide: int = CRYPTO_RC4 | CRYPTO_PLAINTEXT,
):
    """Outbound MSE handshake (we are A, the initiator).

    ``ia`` is the initial payload (normally the BT handshake) sent
    inside the encrypted negotiation so an extra round-trip is saved.
    Returns the socket to continue on: an ``EncryptedSocket`` when RC4
    was selected, the raw socket when the receiver chose plaintext.
    Raises MSEError when the remote is not an MSE peer (callers fall
    back per policy).
    """
    private, public = _keypair()
    sock.sendall(public + _pad())  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)
    yb = _recv_exact(sock, DH_KEY_BYTES)
    s = _secret(private, yb)

    tx = RC4(_sha1(b"keyA", s, info_hash), drop=RC4_DROP)
    rx = RC4(_sha1(b"keyB", s, info_hash), drop=RC4_DROP)

    req2_xor_req3 = _xor(_sha1(b"req2", info_hash), _sha1(b"req3", s))
    tail = VC + struct.pack(">I", crypto_provide) + struct.pack(">H", 0)
    tail += struct.pack(">H", len(ia)) + ia
    sock.sendall(_sha1(b"req1", s) + req2_xor_req3 + tx.crypt(tail))  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)

    # B's reply: sync on ENCRYPT_B(VC). VC is zeros, so its ciphertext
    # IS the first 8 keystream bytes of rx — a fixed marker.
    marker = rx.crypt(VC)
    surplus = _sync_on(sock, marker, DH_KEY_BYTES + MAX_PAD + len(marker), b"")

    def read_encrypted(count: int) -> bytes:  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)
        nonlocal surplus
        while len(surplus) < count:
            chunk = sock.recv(4096)
            if not chunk:
                raise MSEError("peer closed during MSE negotiation")
            surplus += chunk
        take, surplus = surplus[:count], surplus[count:]
        return rx.crypt(take)

    crypto_select = struct.unpack(">I", read_encrypted(4))[0]
    pad_d_len = struct.unpack(">H", read_encrypted(2))[0]
    if pad_d_len > MAX_PAD:
        raise MSEError(f"oversized PadD: {pad_d_len}")
    read_encrypted(pad_d_len)

    if crypto_select == CRYPTO_RC4 and crypto_provide & CRYPTO_RC4:
        return EncryptedSocket(sock, tx, rx, buffered=rx.crypt(surplus))
    if crypto_select == CRYPTO_PLAINTEXT and crypto_provide & CRYPTO_PLAINTEXT:
        if surplus:
            # B already sent plaintext payload past PadD; carry it
            return EncryptedSocket(sock, None, None, buffered=bytes(surplus))
        return sock
    raise MSEError(f"receiver selected unoffered crypto {crypto_select:#x}")


def accept(
    sock: socket.socket,
    info_hash: bytes,
    prefix: bytes = b"",
    allow_plaintext: bool = True,
):
    """Inbound MSE handshake (we are B, the receiver). ``prefix`` is
    whatever the caller already read while detecting that this is not a
    plaintext BT handshake.

    Returns ``(sock_like, ia)``: the socket to continue on and the
    initiator's initial payload (the start of the BT handshake,
    possibly empty).
    """
    if len(prefix) > DH_KEY_BYTES:
        raise MSEError("oversized detection prefix")
    ya = prefix + _recv_exact(sock, DH_KEY_BYTES - len(prefix))
    private, public = _keypair()
    sock.sendall(public + _pad())  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)
    s = _secret(private, ya)

    surplus = _sync_on(sock, _sha1(b"req1", s), _SYNC_WINDOW, b"")

    def read_raw(count: int) -> bytes:  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)
        nonlocal surplus
        while len(surplus) < count:
            chunk = sock.recv(4096)
            if not chunk:
                raise MSEError("peer closed during MSE negotiation")
            surplus += chunk
        take, surplus = surplus[:count], surplus[count:]
        return take

    obfuscated = read_raw(20)
    if _xor(obfuscated, _sha1(b"req3", s)) != _sha1(b"req2", info_hash):
        # the initiator is asking for a torrent this endpoint isn't
        # serving (or isn't MSE at all)
        raise MSEError("MSE initiator requested an unknown info-hash")

    rx = RC4(_sha1(b"keyA", s, info_hash), drop=RC4_DROP)
    tx = RC4(_sha1(b"keyB", s, info_hash), drop=RC4_DROP)

    def read_encrypted(count: int) -> bytes:
        return rx.crypt(read_raw(count))

    if read_encrypted(8) != VC:
        raise MSEError("bad MSE verification constant")
    crypto_provide = struct.unpack(">I", read_encrypted(4))[0]
    pad_c_len = struct.unpack(">H", read_encrypted(2))[0]
    if pad_c_len > MAX_PAD:
        raise MSEError(f"oversized PadC: {pad_c_len}")
    read_encrypted(pad_c_len)
    ia_len = struct.unpack(">H", read_encrypted(2))[0]
    ia = read_encrypted(ia_len) if ia_len else b""

    if crypto_provide & CRYPTO_RC4:
        crypto_select = CRYPTO_RC4
    elif crypto_provide & CRYPTO_PLAINTEXT and allow_plaintext:
        crypto_select = CRYPTO_PLAINTEXT
    else:
        raise MSEError(f"no acceptable crypto in provide {crypto_provide:#x}")

    reply = VC + struct.pack(">I", crypto_select) + struct.pack(">H", 0)
    sock.sendall(tx.crypt(reply))  # deadline: handshake sockets carry the caller's settimeout (peerwire dial, inbound listener 120s)

    if crypto_select == CRYPTO_RC4:
        return EncryptedSocket(sock, tx, rx, buffered=rx.crypt(surplus)), ia
    # plaintext: whatever followed the negotiation is plaintext payload
    if surplus:
        return EncryptedSocket(sock, None, None, buffered=bytes(surplus)), ia
    return sock, ia
