"""uTP — the micro transport protocol (BEP 29) over UDP.

The reference's anacrolix client speaks uTP alongside TCP by default
(torrent.go:44 builds the default client; NAT'd swarm peers are often
reachable ONLY over uTP because UDP hole-punching works where inbound
TCP does not). This module implements the protocol from scratch on a
stdlib UDP socket:

- the 20-byte header (type/ver, connection ids, microsecond timestamps,
  advertised window, seq/ack numbers),
- three-way-ish setup (ST_SYN → ST_STATE), ordered reliable delivery
  with out-of-order reassembly, ST_FIN teardown, ST_RESET on unknown
  connections,
- retransmission with exponential backoff,
- the full BEP 29 congestion controller: LEDBAT delay-based windowing
  (target 100 ms one-way queuing delay, scaled gain, base-delay
  tracked as a rolling 2-minute minimum of the remote's echoed
  timestamp_diff) with multiplicative decrease on loss. Plain AIMD
  remains as a config fallback (``UTP_CONGESTION=aimd`` or
  ``UTPMultiplexer(congestion="aimd")``) for datacenter paths where
  yielding to foreground traffic is not wanted,
- selective acks (extension 1), both directions: the receiver attaches
  a SACK bitmask to acks while its reassembly buffer holds a gap, and
  the sender treats sacked packets as delivered (LEDBAT receivers
  never renege), fast-retransmitting the head once 3+ later packets
  are sacked — recovering multi-loss windows without RTO stalls
  (``UTP_SACK=off`` disables emission).

A ``UTPSocket`` duck-types the blocking ``socket.socket`` surface the
peer wire uses (``sendall``/``recv``/``settimeout``/``close``/
``fileno``/``pending``), so the BT handshake, MSE encryption (mse.py),
and the message framing run over uTP unchanged. ``fileno`` returns a
self-pipe armed whenever ordered bytes are ready, so SocketWaiter
readiness polls work even though a background thread drains the UDP
socket itself.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
import threading
import time

from ..utils import get_logger
from .dualstack import bind_dual_stack_udp, display_form

log = get_logger("fetch.utp")

ST_DATA = 0
ST_FIN = 1
ST_STATE = 2
ST_RESET = 3
ST_SYN = 4

VERSION = 1
HEADER = struct.Struct(">BBHIIIHH")  # type/ver, ext, conn_id, ts, ts_diff, wnd, seq, ack
HEADER_LEN = HEADER.size

# conservative payload size: fits every real-world MTU incl. tunnels
MSS = 1400
# advertised receive window (bytes) — also the reassembly buffer cap
RECV_WINDOW = 1 << 20
# AIMD congestion window bounds, in packets
CWND_INIT = 16
CWND_MIN = 2
CWND_MAX = 256
RTO_INIT = 0.5
RTO_MAX = 8.0
# LEDBAT (BEP 29 / RFC 6817): target one-way queuing delay and gain —
# at most GAIN packets of window change per window's worth of acks
LEDBAT_TARGET_US = 100_000
LEDBAT_GAIN = 1.0
BASE_DELAY_WINDOW = 60.0  # base-delay bucket width (2 buckets kept)
SACK_MAX_BYTES = 32  # bitmask cap: 256 packets = CWND_MAX
CONNECT_TIMEOUT = 10.0
ACK_EVERY = 4  # delayed-ack stride; the mux tick flushes stragglers


class UTPError(OSError):
    """Transport-level failure (reset, timeout, teardown)."""


def _now_us() -> int:
    return time.monotonic_ns() // 1000 & 0xFFFFFFFF


def _pack(
    ptype: int,
    conn_id: int,
    ts_diff: int,
    wnd: int,
    seq: int,
    ack: int,
    payload: bytes = b"",
    sack: bytes = b"",
) -> bytes:
    header = HEADER.pack(
        (ptype << 4) | VERSION,
        1 if sack else 0,  # first-extension type: 1 = selective ack
        conn_id,
        _now_us(),
        ts_diff & 0xFFFFFFFF,
        wnd,
        seq,
        ack,
    )
    if sack:
        # extension block: [type-of-next-ext, length, bitmask]
        header += bytes((0, len(sack))) + sack
    return header + payload


def _restamp(pkt: bytes) -> bytes:
    """Fresh header timestamp for a retransmission: resending the
    original bytes would make the receiver echo the ORIGINAL send
    time's delta as timestamp_diff, which LEDBAT would read as hundreds
    of ms of queuing and collapse the window (libutp re-stamps too)."""
    return pkt[:4] + struct.pack(">I", _now_us()) + pkt[8:]


def _seq_lt(a: int, b: int) -> bool:
    """a < b in mod-65536 sequence space."""
    return 0 < (b - a) & 0xFFFF < 0x8000


def _delay_lt(a: int, b: int) -> bool:
    """a < b in mod-2^32 delay space: timestamp_diff samples embed an
    arbitrary inter-host clock offset mod 2^32, so plain comparisons
    misread samples that straddle the wrap boundary."""
    return 0 < (b - a) & 0xFFFFFFFF < 1 << 31


class UTPSocket:
    """One uTP stream. Created via ``connect()`` (initiator) or handed
    to the listener's accept callback (receiver). Thread-safe like a
    socket: one reader and one writer may run concurrently."""

    def __init__(
        self,
        mux: "UTPMultiplexer",
        addr,
        send_id: int,
        recv_id: int,
        congestion: str = "ledbat",
        emit_sack: bool = True,
        wire_addr=None,
    ):
        self._mux = mux
        # addr is the DISPLAY/identity form (v4-mapped v6 collapsed to
        # dotted quad); wire_addr is what sendto needs on the mux's
        # socket family (the mapped form on a dual-stack socket)
        self.addr = addr
        self._wire_addr = wire_addr or addr
        self._send_id = send_id
        self._recv_id = recv_id
        self._congestion = congestion
        self._emit_sack = emit_sack
        # LEDBAT: rolling base-delay minimum of the remote's echoed
        # timestamp_diff (two BASE_DELAY_WINDOW buckets = ~2 min
        # history; the clock-skew constant cancels in sample - base)
        self._delay_min_cur: int | None = None
        self._delay_min_prev: int | None = None
        self._delay_bucket_at = time.monotonic()
        # fast-recovery: window was last cut at this time — one
        # multiplicative decrease per RTT-ish episode, not per resend
        self._last_cut = 0.0
        # consecutive RTO expiries without cumulative progress: drives
        # the RTO's exponential backoff AND the give-up limit. Distinct
        # from the per-packet resend count — sack/dup-ack-paced resends
        # are frequent by design and must inflate neither.
        self._rto_backoff = 0
        self.rto_retransmits = 0  # timeout-driven resends (observability)
        self._lock = threading.Lock()
        self._readable = threading.Condition(self._lock)
        self._writable = threading.Condition(self._lock)
        self._timeout: float | None = None
        # tx state
        self._seq = secrets.randbelow(0xFFFF) + 1
        self._inflight: dict[int, tuple[bytes, float, int]] = {}  # seq -> (pkt, sent_at, tries)
        self._cwnd = CWND_INIT
        self._rtt = RTO_INIT
        self._peer_wnd = RECV_WINDOW
        self._dup_acks = 0
        self._last_ack_seen = -1
        # rx state
        self._ack = 0  # last in-order seq received
        self._ooo: dict[int, bytes] = {}  # out-of-order reassembly
        self._ooo_bytes = 0  # bytes buffered in _ooo (RECV_WINDOW cap)
        self._stream = bytearray()  # ordered bytes ready for recv()
        self._last_ts_diff = 0
        self._fin_seq: int | None = None
        self._unacked = 0  # in-order packets since the last ack sent
        self._eof = False
        self._error: Exception | None = None
        self._connected = threading.Event()
        self._closed = False
        self._torn_down = False
        # self-pipe: armed while _stream/_eof/_error would let recv()
        # return, so selector-based waits (SocketWaiter) see readiness
        # even though the mux thread drains the UDP fd itself
        self._pipe_r, self._pipe_w = os.pipe()
        os.set_blocking(self._pipe_r, False)
        os.set_blocking(self._pipe_w, False)
        self._pipe_armed = False

    # -- plumbing --------------------------------------------------------

    def _arm_pipe_locked(self) -> None:
        if not self._pipe_armed:
            self._pipe_armed = True
            try:
                os.write(self._pipe_w, b"x")
            except OSError:
                pass

    def _disarm_pipe_locked(self) -> None:
        if self._pipe_armed and not (self._stream or self._eof or self._error):
            self._pipe_armed = False
            try:
                while os.read(self._pipe_r, 64):
                    pass
            except OSError:
                pass

    def _send_raw(self, data: bytes) -> None:
        try:
            # analysis: ignore[no-blocking-under-lock] UDP datagram send: the kernel queues or drops, it never parks on the remote; loss is the retransmit machinery's job
            self._mux.sock.sendto(data, self._wire_addr)
        except OSError:
            pass  # transient; retransmit machinery covers loss

    def _send_ack_locked(self) -> None:
        self._send_raw(
            _pack(
                ST_STATE,
                self._send_id,
                self._last_ts_diff,
                max(0, RECV_WINDOW - len(self._stream)),
                self._seq,
                self._ack,
                sack=self._build_sack_locked(),
            )
        )

    def _build_sack_locked(self) -> bytes:
        """Selective-ack bitmask (BEP 29 extension 1) over the
        reassembly buffer: bit i of byte i>>3 represents seq
        ack_nr + 2 + i. Empty when there is no gap."""
        if not self._ooo or not self._emit_sack:
            return b""
        base_seq = (self._ack + 2) & 0xFFFF
        bits = bytearray(4)  # spec: at least 4 bytes, multiples of 4
        for s in self._ooo:
            i = (s - base_seq) & 0xFFFF
            if i >= SACK_MAX_BYTES * 8:
                continue  # beyond the mask cap: cumulative ack covers it later
            needed = ((i >> 5) + 1) * 4  # grow in 4-byte steps
            if needed > len(bits):
                bits.extend(bytes(needed - len(bits)))
            bits[i >> 3] |= 1 << (i & 7)
        return bytes(bits)

    # -- mux-thread entry points ----------------------------------------

    def _on_packet(
        self,
        ptype: int,
        seq: int,
        ack: int,
        ts: int,
        ts_diff: int,
        wnd: int,
        payload: bytes,
        sack: bytes = b"",
    ) -> None:
        with self._lock:
            self._on_packet_locked(
                ptype, seq, ack, ts, ts_diff, wnd, payload, sack
            )
            teardown = self._closed and (
                not self._inflight or self._error is not None
            )
        if teardown:
            self._maybe_teardown()

    def _on_packet_locked(
        self, ptype, seq, ack, ts, ts_diff, wnd, payload, sack=b""
    ) -> None:
        self._last_ts_diff = (_now_us() - ts) & 0xFFFFFFFF
        self._peer_wnd = wnd
        if ptype == ST_RESET:
            self._error = UTPError("connection reset by peer")
            self._readable.notify_all()
            self._writable.notify_all()
            self._arm_pipe_locked()
            return
        # ack processing (every packet type carries ack_nr)
        acked = [s for s in self._inflight if not _seq_lt(ack, s)]
        # selective acks: packets the remote holds past the cumulative
        # ack are DELIVERED (a BEP 29 reassembly buffer never reneges,
        # unlike TCP SACK), so they leave the in-flight window now
        # instead of being resent after the head's recovery
        sacked: list[int] = []
        if sack and self._inflight:
            base_seq = (ack + 2) & 0xFFFF
            for i in range(len(sack) * 8):
                if sack[i >> 3] & (1 << (i & 7)):
                    s = (base_seq + i) & 0xFFFF
                    if s in self._inflight:
                        sacked.append(s)
        if acked or sacked:
            for s in acked:
                pkt, sent_at, tries = self._inflight.pop(s)
                if tries == 1 and s == ack:
                    # Karn's rule: only first-transmission samples
                    sample = time.monotonic() - sent_at
                    self._rtt = 0.8 * self._rtt + 0.2 * sample
            for s in sacked:
                self._inflight.pop(s, None)  # no rtt sample: not cumulative
            self._grow_cwnd_locked(len(acked) + len(sacked), ts_diff)
            self._writable.notify_all()
        if acked:
            self._dup_acks = 0
            self._rto_backoff = 0  # cumulative progress: path is alive
        elif self._inflight and ptype == ST_STATE and not sack:
            # a pure SACK-LESS ack that acks nothing while data is in
            # flight (with a sack block attached, the sack rule below
            # is strictly better loss information than blind counting):
            # the remote is missing our head-of-line packet (it acks
            # immediately on every gap arrival — delayed acks mean the
            # value itself may differ from the last one we saw, so no
            # equality test). Only payload-free ST_STATE counts — TCP's
            # rule that only pure acks are duplicates: on a
            # bidirectional transfer the remote's ST_DATA packets
            # legitimately repeat an unchanged ack_nr whenever WE have
            # an in-flight gap, and counting those would fire spurious
            # head retransmits and halve cwnd repeatedly. Two in a row
            # = fast retransmit without waiting out the RTO: AIMD keeps
            # the window small after a loss, so TCP's classic 3 may
            # never accumulate, and a spurious head retransmit costs
            # one packet.
            self._dup_acks += 1
            if self._dup_acks >= 2:
                # NOT reset on firing: while progress stays absent,
                # every further duplicate re-signals the same loss (a
                # resend may itself have died); the resend pacing in
                # _retransmit_head_locked dedupes the actual sends
                self._retransmit_head_locked(time.monotonic())
        self._last_ack_seen = ack
        # SACK loss signal (libutp's rule): 3+ packets sacked beyond
        # the head prove the head was lost, not merely delayed — resend
        # it without waiting out dup-acks or the RTO. Repeat firings
        # for the same gap (every gap-advertising ack repeats the
        # sack) are deduplicated by the resend pacing, which also
        # covers the resend-itself-lost case at tick cadence.
        if sack and self._inflight:
            head = min(
                self._inflight,
                key=lambda s: (s - self._last_ack_seen) & 0xFFFF,
            )
            base_seq = (ack + 2) & 0xFFFF
            later = 0
            for i in range(len(sack) * 8):
                if sack[i >> 3] & (1 << (i & 7)) and _seq_lt(
                    head, (base_seq + i) & 0xFFFF
                ):
                    later += 1
            if later >= 3:
                self._retransmit_head_locked(time.monotonic())
        if ptype == ST_STATE:
            if not self._connected.is_set():
                # the SYN-ACK's seq is the remote's initial seq; its
                # first DATA will carry this same number (libutp
                # semantics: the SYN-ACK does not consume a seq)
                self._ack = (seq - 1) & 0xFFFF
                self._connected.set()
            return
        if ptype == ST_DATA:
            self._on_data_locked(seq, payload)
        elif ptype == ST_FIN:
            # EOF only once everything before the FIN's seq has been
            # delivered — DATA still being retransmitted must not be
            # truncated by an early FIN arrival
            self._fin_seq = seq
            self._on_data_locked(seq, b"")

    def _on_data_locked(self, seq: int, payload: bytes) -> None:
        is_next = seq == (self._ack + 1) & 0xFFFF
        gap = payload and not is_next
        had_gap = bool(self._ooo)
        if payload and _seq_lt(self._ack, seq) and seq not in self._ooo:
            # cap the reassembly buffer on actual buffered BYTES (a
            # per-entry cap times MSS undercounts sub-MSS datagrams and
            # could reject a retransmitted head while ~749 tiny packets
            # sit buffered) — and ALWAYS admit the next-in-order packet
            # regardless of the cap: it drains _ooo immediately below,
            # so rejecting it would deadlock the very packet that frees
            # the buffer
            if is_next or self._ooo_bytes < RECV_WINDOW:
                self._ooo[seq] = payload
                self._ooo_bytes += len(payload)
        # drain everything now in order
        while (self._ack + 1) & 0xFFFF in self._ooo:
            self._ack = (self._ack + 1) & 0xFFFF
            drained = self._ooo.pop(self._ack)
            self._ooo_bytes -= len(drained)
            self._stream += drained
            self._unacked += 1
        if self._fin_seq is not None and (self._ack + 1) & 0xFFFF == self._fin_seq:
            self._ack = self._fin_seq  # consume the FIN's slot
            self._eof = True
        # delayed ack: per-packet acks dominate CPU at loopback rates;
        # ack on a gap (the sender's loss signal), on an in-order
        # arrival while a gap was outstanding (it was the
        # retransmission the sender is pacing resends against —
        # deferring THAT ack makes the sender refire spuriously until
        # the delayed ack finally goes out), every ACK_EVERY in-order
        # packets, at EOF, and from the mux tick otherwise
        recovered = bool(payload) and is_next and had_gap
        if gap or recovered or self._unacked >= ACK_EVERY or self._eof:
            self._send_ack_locked()
            self._unacked = 0
        if self._stream or self._eof:
            self._readable.notify_all()
            self._arm_pipe_locked()

    def _grow_cwnd_locked(self, n_acked: int, echoed_delay: int) -> None:
        """Window growth on ack progress. LEDBAT: the remote's echoed
        timestamp_diff is our packets' one-way delay; its excess over
        the rolling base delay is queuing WE caused. The window scales
        toward the 100 ms target — grows below it, shrinks above it —
        by at most LEDBAT_GAIN packets per window of acks (RFC 6817's
        scaled gain). AIMD mode (and packets without a usable delay
        echo, e.g. the handshake) grow additively, one packet per
        window."""
        if self._congestion == "ledbat" and echoed_delay:
            now = time.monotonic()
            if now - self._delay_bucket_at >= BASE_DELAY_WINDOW:
                self._delay_min_prev = self._delay_min_cur
                self._delay_min_cur = None
                self._delay_bucket_at = now
            # min/subtract in wrapping space: the samples carry the
            # clock offset mod 2^32, so around the wrap boundary the
            # smaller NUMBER is not the smaller DELAY — a plain min
            # would latch a phantom base and read ~2^32 µs of queuing
            # forever (libutp compares wrapping too)
            if self._delay_min_cur is None or _delay_lt(
                echoed_delay, self._delay_min_cur
            ):
                self._delay_min_cur = echoed_delay
            base = self._delay_min_cur
            if self._delay_min_prev is not None and _delay_lt(
                self._delay_min_prev, base
            ):
                base = self._delay_min_prev
            queuing = (echoed_delay - base) & 0xFFFFFFFF
            if queuing >= 1 << 31:
                queuing = 0  # sample below base: rebase already latched
            off_target = (LEDBAT_TARGET_US - queuing) / LEDBAT_TARGET_US
            off_target = max(-1.0, min(1.0, off_target))
            self._cwnd = max(
                CWND_MIN,
                min(
                    CWND_MAX,
                    self._cwnd
                    + LEDBAT_GAIN
                    * off_target
                    * max(1, n_acked)
                    / max(1, self._cwnd),
                ),
            )
        else:
            self._cwnd = min(
                CWND_MAX, self._cwnd + max(1, n_acked) / max(1, self._cwnd)
            )

    def _on_tick(self) -> None:
        """Mux timer: flush a straggling delayed ack; retransmit
        expired in-flight packets."""
        with self._lock:
            if self._unacked:
                self._send_ack_locked()
                self._unacked = 0
            elif self._ooo and self._error is None:
                # a gap is outstanding but nothing new is arriving —
                # the retransmission we're waiting for may itself have
                # been lost, and with no inbound data we'd otherwise
                # send no acks at all, leaving the remote only its
                # (exponentially backed-off) RTO. Re-advertise the gap
                # (with SACK) every tick so the remote's dup-ack/sack
                # machinery re-fires at tick cadence instead.
                self._send_ack_locked()
            now = time.monotonic()
            if self._error is None and self._inflight:
                # retransmit ONLY the head-of-line packet: everything
                # behind it is (with high probability) sitting in the
                # remote's reassembly buffer, and resending the whole
                # window both wastes bandwidth and can phase-lock with
                # a periodic loss pattern, starving one packet forever
                rto = min(RTO_MAX, max(RTO_INIT, self._rtt * 3))
                head = min(
                    self._inflight,
                    key=lambda s: (s - self._last_ack_seen) & 0xFFFF,
                )
                pkt, sent_at, tries = self._inflight[head]
                # backoff exponent = consecutive RTO expiries without
                # progress, NOT the packet's total resend count: paced
                # fast retransmits are frequent by design, and letting
                # them inflate the exponent would push the give-up
                # horizon from ~30 s out to minutes on a dead path
                if now - sent_at >= rto * (2**self._rto_backoff):
                    if self._rto_backoff >= 5:
                        self._error = UTPError(
                            "uTP retransmission limit reached"
                        )
                        self._readable.notify_all()
                        self._writable.notify_all()
                        self._arm_pipe_locked()
                    else:
                        self._rto_backoff += 1
                        self.rto_retransmits += 1
                        self._retransmit_head_locked(now, force=True)
            teardown = self._closed and (
                not self._inflight or self._error is not None
            )
        if teardown:
            self._maybe_teardown()

    def _retransmit_head_locked(self, now: float, force: bool = False) -> None:
        if not self._inflight:
            return
        head = min(
            self._inflight, key=lambda s: (s - self._last_ack_seen) & 0xFFFF
        )
        pkt, sent_at, tries = self._inflight[head]
        # pace resends: dup-acks and sack signals keep arriving for the
        # SAME gap while a just-sent resend is still in flight — give
        # each resend ~half an RTT to land before firing again, clamped
        # to [10 ms, 50 ms]: the rtt estimate includes delayed-ack
        # latency and inflates under loss, and an unclamped window
        # would slow every recovery to that inflated pace (the RTO
        # path forces, it IS the give-up timer)
        if not force and now - sent_at < min(max(0.5 * self._rtt, 0.01), 0.05):
            return
        # loss signal: multiplicative decrease — once per RTT-ish
        # episode (sack-triggered, dup-ack and RTO paths all land
        # here; cutting per resend would collapse to CWND_MIN on any
        # lossy stretch)
        if now - self._last_cut > max(self._rtt, 0.05):
            self._last_cut = now
            self._cwnd = max(CWND_MIN, self._cwnd / 2)
        pkt = _restamp(pkt)
        self._send_raw(pkt)
        self._inflight[head] = (pkt, now, tries + 1)

    # -- initiator handshake --------------------------------------------

    def _connect(self, timeout: float) -> None:
        syn_seq = self._seq
        pkt = _pack(ST_SYN, self._recv_id, 0, RECV_WINDOW, syn_seq, 0)
        with self._lock:
            self._inflight[syn_seq] = (pkt, time.monotonic(), 1)
            self._seq = (self._seq + 1) & 0xFFFF
        self._send_raw(pkt)
        if not self._connected.wait(timeout):
            self.close()
            raise UTPError(f"uTP connect to {self.addr} timed out")
        with self._lock:
            self._inflight.pop(syn_seq, None)

    def _accept(self, syn_seq: int) -> None:
        """Receiver side: our ack starts at the remote's SYN seq."""
        with self._lock:
            self._ack = syn_seq
            self._send_ack_locked()

    # -- socket surface --------------------------------------------------

    def settimeout(self, value: float | None) -> None:
        self._timeout = value

    def fileno(self) -> int:
        return self._pipe_r

    def pending(self) -> int:
        with self._lock:
            return len(self._stream)

    def sendall(self, data: bytes) -> None:
        view = memoryview(data)  # no copy; sliced per MSS chunk below
        offset = 0
        deadline = (
            time.monotonic() + self._timeout if self._timeout is not None else None
        )
        while offset < len(view):
            with self._lock:
                if self._error is not None:
                    raise UTPError(str(self._error))
                if self._closed:
                    raise UTPError("socket closed")
                window = min(
                    int(self._cwnd), max(1, self._peer_wnd // MSS)
                )
                if len(self._inflight) >= window:
                    wait = 1.0  # bounded so retransmit ticks re-check
                    if deadline is not None:
                        remain = deadline - time.monotonic()
                        if remain <= 0:
                            raise UTPError("uTP send timed out")
                        wait = min(wait, remain)
                    # analysis: ignore[no-blocking-under-lock] Condition on self._lock releases it while waiting
                    self._writable.wait(timeout=wait)
                    continue
                chunk = bytes(view[offset : offset + MSS])
                seq = self._seq
                self._seq = (self._seq + 1) & 0xFFFF
                pkt = _pack(
                    ST_DATA,
                    self._send_id,
                    self._last_ts_diff,
                    max(0, RECV_WINDOW - len(self._stream)),
                    seq,
                    self._ack,
                    chunk,
                )
                self._inflight[seq] = (pkt, time.monotonic(), 1)
            self._send_raw(pkt)
            offset += len(chunk)

    def recv(self, count: int) -> bytes:
        deadline = (
            time.monotonic() + self._timeout if self._timeout is not None else None
        )
        with self._lock:
            while not self._stream:
                # clean EOF beats a late error: a RESET that raced in
                # after the remote's FIN (e.g. its teardown answered our
                # final ack) must not turn a complete stream into a
                # failure
                if self._eof or self._closed:
                    return b""
                if self._error is not None:
                    raise UTPError(str(self._error))
                remain = None
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        raise TimeoutError("timed out")
                # analysis: ignore[no-blocking-under-lock] Condition on self._lock releases it while waiting
                self._readable.wait(timeout=remain)
            take = bytes(self._stream[:count])
            del self._stream[:count]
            self._disarm_pipe_locked()
            return take

    def close(self) -> None:
        """Send FIN and tear down. The FIN rides the normal retransmit
        machinery (a dropped FIN would otherwise leave the remote
        blocked forever), so deregistration from the mux happens when
        the FIN is acked — or when its retries are exhausted."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            fin_seq = self._seq
            self._seq = (self._seq + 1) & 0xFFFF
            fin = _pack(
                ST_FIN,
                self._send_id,
                self._last_ts_diff,
                0,
                fin_seq,
                self._ack,
            )
            if self._error is None:
                self._inflight[fin_seq] = (fin, time.monotonic(), 1)
            self._readable.notify_all()
            self._writable.notify_all()
            self._arm_pipe_locked()
        self._send_raw(fin)
        self._maybe_teardown()

    def _maybe_teardown(self) -> None:
        """Final deregistration once closed and nothing awaits an ack."""
        with self._lock:
            if not self._closed:
                return
            if self._inflight and self._error is None:
                return  # FIN (or tail data) still awaiting ack
            if self._torn_down:
                return
            self._torn_down = True
        self._mux._discard(self)
        for fd in (self._pipe_r, self._pipe_w):
            try:
                os.close(fd)
            except OSError:
                pass


class UTPMultiplexer:
    """Owns one UDP socket and demultiplexes datagrams to streams by
    (address, connection id). The listener shares its port number with
    the TCP listener — BEP 29 peers expect uTP on the announced port —
    and outbound connections can ride an ephemeral-port multiplexer.

    ``on_accept(utp_socket)`` is invoked (on the mux thread) for each
    inbound SYN when accepting is enabled."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        on_accept=None,
        sock: socket.socket | None = None,
        congestion: str | None = None,
        emit_sack: bool | None = None,
    ):
        self.on_accept = on_accept
        # congestion controller for every stream on this mux: "ledbat"
        # (BEP 29 default) or "aimd" (config fallback); env overrides
        # for the CLI/daemon without plumbing a flag through the stack
        if congestion is None:
            congestion = os.environ.get("UTP_CONGESTION", "ledbat").lower()
            if congestion not in ("ledbat", "aimd"):
                congestion = "ledbat"  # env typo: safe default
        else:
            congestion = congestion.lower()
            if congestion not in ("ledbat", "aimd"):
                # an explicit argument is code, not config: fail loud
                raise ValueError(f"unknown congestion mode {congestion!r}")
        self.congestion = congestion
        if emit_sack is None:
            emit_sack = os.environ.get("UTP_SACK", "on").lower() not in (
                "off", "0", "false",
            )
        self.emit_sack = emit_sack
        if sock is not None:
            self.sock = sock
        else:
            # dual-stack when listening on the any-address: one
            # AF_INET6 socket with V6ONLY off takes v4 peers as
            # ::ffff:a.b.c.d AND real v6 peers (anacrolix's uTP is
            # dual-stack too). Explicit hosts pin the family; v6-less
            # stacks fall back to plain AF_INET.
            self.sock = bind_dual_stack_udp(host, port)
        # tick granularity: retransmit checks AND the gap
        # re-advertisement cadence — a window-stalled sender recovers
        # one loss per gap re-advert, so the tick bounds per-loss
        # recovery latency for sack-less remotes
        self.sock.settimeout(0.05)
        self.port = self.sock.getsockname()[1]
        self._lock = threading.Lock()
        self._conns: dict[tuple, UTPSocket] = {}  # (addr, recv_id) -> conn
        self._closed = False
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name=f"utp-mux-{self.port}"
        )
        self._thread.start()

    @staticmethod
    def _display_form(addr) -> tuple[str, int]:
        """Stable identity for a peer address (dualstack.display_form):
        conn keys and ``conn.addr`` look the same regardless of the
        mux's socket family."""
        return display_form(addr)

    def _resolve(self, addr) -> tuple[tuple[str, int], tuple[str, int]]:
        """(display, wire) forms of a dial target for THIS socket's
        family. On a v4-only mux a v6 target raises gaierror, which the
        caller's transport fallback treats as uTP failing — those
        peers are reached over TCP instead."""
        family = self.sock.family
        flags = socket.AI_V4MAPPED if family == socket.AF_INET6 else 0
        try:
            info = socket.getaddrinfo(
                addr[0], addr[1], family=family,
                type=socket.SOCK_DGRAM, flags=flags,
            )
        except socket.gaierror:
            if family != socket.AF_INET6:
                raise
            # musl libc ignores AI_V4MAPPED: resolve family-agnostic
            # and hand-map a v4 result so Alpine containers can still
            # dial v4 peers from the dual-stack socket
            info = socket.getaddrinfo(
                addr[0], addr[1], type=socket.SOCK_DGRAM
            )
            for entry_family, _, _, _, sockaddr in info:
                if entry_family == socket.AF_INET:
                    wire = (f"::ffff:{sockaddr[0]}", sockaddr[1])
                    return self._display_form(wire), wire
            raise
        wire = info[0][4][:2]
        return self._display_form(wire), wire

    def connect(self, addr, timeout: float = CONNECT_TIMEOUT) -> UTPSocket:
        """Initiate a stream to ``addr``; blocks until the SYN is
        acked. Dual-stack: an any-address mux reaches v4 and v6 peers
        alike; an explicitly v4-bound mux raises gaierror for v6
        targets (the caller's transport fallback then dials TCP)."""
        display, wire = self._resolve(addr)
        with self._lock:
            if self._closed:
                raise UTPError("multiplexer closed")
            while True:
                recv_id = secrets.randbelow(0xFFFE)
                if (display, recv_id) not in self._conns:
                    break
            # spec: the SYN carries our RECEIVE id; we send data with
            # recv_id + 1 and the remote replies labeled recv_id
            conn = UTPSocket(
                self,
                display,
                send_id=(recv_id + 1) & 0xFFFF,
                recv_id=recv_id,
                congestion=self.congestion,
                emit_sack=self.emit_sack,
                wire_addr=wire,
            )
            self._conns[(display, recv_id)] = conn
        conn._connect(timeout)
        return conn

    def _discard(self, conn: UTPSocket) -> None:
        with self._lock:
            for key, value in list(self._conns.items()):
                if value is conn:
                    del self._conns[key]

    def _pump(self) -> None:
        while True:
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                # idle tick: snapshot the conns only here — the hot
                # per-datagram path below looks up exactly one conn
                with self._lock:
                    if self._closed:
                        return
                    conns = list(self._conns.values())
                for conn in conns:
                    try:
                        conn._on_tick()
                    except Exception as exc:
                        # one stream's bug must not kill the pump: this
                        # thread is the ONLY reader of the shared UDP
                        # socket, so its death deadlocks every stream
                        log.warning(f"uTP tick failed: {exc}")
                continue
            except OSError:
                return  # closed
            if len(data) < HEADER_LEN:
                continue
            type_ver, ext, conn_id, ts, ts_diff, wnd, seq, ack = HEADER.unpack_from(
                data
            )
            ptype, version = type_ver >> 4, type_ver & 0x0F
            if version != VERSION or ptype > ST_SYN:
                continue
            payload = data[HEADER_LEN:]
            sack = b""
            if ext:
                # walk the extension chain; type 1 = selective ack
                # (other types are skipped — we never negotiate any)
                offset = HEADER_LEN
                current = ext
                try:
                    while current:
                        next_ext, ext_len = data[offset], data[offset + 1]
                        block = data[offset + 2 : offset + 2 + ext_len]
                        if len(block) < ext_len:
                            raise IndexError
                        if current == 1:
                            sack = block
                        current = next_ext
                        offset += 2 + ext_len
                    payload = data[offset:]
                except IndexError:
                    continue  # malformed extension chain
            display = self._display_form(addr)
            try:
                if ptype == ST_SYN:
                    self._on_syn(display, addr, conn_id, seq)
                    continue
                with self._lock:
                    conn = self._conns.get((display, conn_id))
                if conn is not None:
                    conn._on_packet(
                        ptype, seq, ack, ts, ts_diff, wnd, payload, sack
                    )
                elif ptype != ST_RESET:
                    # unknown stream: tell the remote to stop retrying
                    try:
                        self.sock.sendto(
                            _pack(ST_RESET, conn_id, 0, 0, 0, seq), addr
                        )
                    except OSError:
                        pass
            except Exception as exc:
                # one malformed datagram or one stream's bug must not
                # kill the pump: this thread is the only reader of the
                # shared UDP socket, so its death deadlocks every
                # stream multiplexed on it
                log.warning(f"uTP packet dispatch failed: {exc}")

    def _on_syn(self, display, raw_addr, conn_id: int, seq: int) -> None:
        if self.on_accept is None:
            try:
                self.sock.sendto(
                    _pack(ST_RESET, conn_id, 0, 0, 0, seq), raw_addr
                )
            except OSError:
                pass
            return
        key = (display, (conn_id + 1) & 0xFFFF)
        with self._lock:
            if self._closed:
                return
            existing = self._conns.get(key)
            if existing is not None:
                # duplicate/delayed SYN (our SYN-ACK was lost, or UDP
                # duplicated it): re-ack, but NEVER rewind _ack — DATA
                # may already have advanced it, and a rewind would make
                # every in-order packet look out-of-order forever
                with existing._lock:
                    existing._send_ack_locked()
                return
            # per spec: receiver sends on the SYN's conn_id, receives
            # on conn_id + 1
            conn = UTPSocket(
                self,
                display,
                send_id=conn_id,
                recv_id=(conn_id + 1) & 0xFFFF,
                congestion=self.congestion,
                emit_sack=self.emit_sack,
                wire_addr=raw_addr[:2],
            )
            self._conns[key] = conn
        conn._accept(seq)
        conn._connected.set()
        try:
            self.on_accept(conn)
        except Exception:  # pragma: no cover - accept callback owns errors
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.close()
        try:
            self.sock.close()
        except OSError:
            pass
