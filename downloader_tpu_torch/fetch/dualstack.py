"""Dual-stack UDP socket + address-form helpers.

Shared by the uTP multiplexer (utp.py) and the DHT node (dht.py), both
of which serve v4 and v6 peers from one AF_INET6 any-socket with
V6ONLY off. Keeping the bind fallback and the two address forms in one
place stops the pair from drifting (a platform V6ONLY quirk or a
mapping bug would otherwise need the same fix twice).

Two address forms:

- display form — peer IDENTITY: v4-mapped v6 (``::ffff:a.b.c.d``, how
  a dual-stack socket reports v4 peers) collapses to the dotted quad,
  and v6 4-tuples drop flowinfo/scope. Tables, connection keys, write
  tokens, and logs use this, so a peer looks the same whether its
  packet came in over v4 or the dual-stack socket.
- wire form — what ``sendto`` needs for a given socket family: v4
  literals get the mapped form on an AF_INET6 socket, hostnames are
  resolved first (an unresolved name would be "mapped" into garbage —
  ``::ffff:router.bittorrent.com`` — and fail), v6 passes through.
"""

from __future__ import annotations

import ipaddress
import socket


def bind_dual_stack_udp(host: str, port: int) -> socket.socket:
    """Bind a UDP socket: dual-stack (AF_INET6, V6ONLY off) when
    ``host`` is an any-address, family pinned by the literal otherwise,
    AF_INET fallback on v6-less stacks. Returns the bound socket;
    raises the last OSError when nothing binds."""
    if host in ("", "0.0.0.0", "::"):
        attempts = [(socket.AF_INET6, "::"), (socket.AF_INET, "0.0.0.0")]
    elif ":" in host:
        attempts = [(socket.AF_INET6, host)]
    else:
        attempts = [(socket.AF_INET, host)]
    last_exc: OSError | None = None
    for family, bind_host in attempts:
        try:
            candidate = socket.socket(family, socket.SOCK_DGRAM)
        except OSError as exc:
            last_exc = exc
            continue
        try:
            if family == socket.AF_INET6 and bind_host == "::":
                candidate.setsockopt(
                    socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0
                )
            candidate.bind((bind_host, port))
        except OSError as exc:
            candidate.close()
            last_exc = exc
            continue
        return candidate
    raise last_exc or OSError("could not bind a UDP socket")


def bind_dual_stack_tcp(host: str, port: int, backlog: int = 16) -> socket.socket:
    """Bind + listen a TCP socket with the same family policy as
    :func:`bind_dual_stack_udp` (dual-stack on the any-address via
    ``create_server(dualstack_ipv6=True)``, family pinned by explicit
    hosts, AF_INET fallback)."""
    if host in ("", "0.0.0.0", "::") and socket.has_dualstack_ipv6():
        try:
            return socket.create_server(
                ("::", port),
                family=socket.AF_INET6,
                backlog=backlog,
                reuse_port=False,
                dualstack_ipv6=True,
            )
        except OSError:
            pass  # fall through to the single-family path
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    listener = socket.socket(family, socket.SOCK_STREAM)
    try:
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if host in ("", "0.0.0.0", "::"):
            # any-address fallback: the bind host must match the socket
            # family — an AF_INET6 socket cannot bind the v4 literal
            # '0.0.0.0' (gaierror), it degrades to a v6-only listener
            # on '::' instead
            bind_host = "::" if family == socket.AF_INET6 else "0.0.0.0"
        else:
            bind_host = host
        listener.bind((bind_host, port))
        listener.listen(backlog)
    except OSError:
        listener.close()
        raise
    return listener


def display_form(addr) -> tuple[str, int]:
    """Stable peer identity (see module docstring)."""
    host, port = addr[0], addr[1]
    if host.startswith("::ffff:") and "." in host:
        host = host[7:]
    return (host, port)


def wire_form(family: int, addr) -> tuple[str, int]:
    """The ``sendto`` form of ``addr`` for a socket of ``family``.

    On AF_INET6: v6 passes through, v4 LITERALS map to ``::ffff:``,
    and hostnames are resolved first (preferring A records, mapped) —
    blindly prefixing a hostname would produce an unroutable string
    and silently break e.g. the DHT's default bootstrap routers."""
    host, port = addr[0], addr[1]
    if family != socket.AF_INET6 or ":" in host:
        return (host, port)
    try:
        ipaddress.ip_address(host)
        return (f"::ffff:{host}", port)
    except ValueError:
        pass  # a hostname, not a literal
    try:
        info = socket.getaddrinfo(host, port, type=socket.SOCK_DGRAM)
    except OSError:
        return (host, port)  # let sendto surface the failure
    # prefer v4 answers (mapped): matches the v4-first posture of the
    # DHT's compact wire format and dht._query_round's resolution
    info.sort(key=lambda entry: entry[0] != socket.AF_INET)
    entry_family, _, _, _, sockaddr = info[0]
    if entry_family == socket.AF_INET:
        return (f"::ffff:{sockaddr[0]}", sockaddr[1])
    return sockaddr[:2]
