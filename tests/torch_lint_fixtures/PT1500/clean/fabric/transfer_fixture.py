"""Clean twin: every socket op armed per-operation and deadline-bounded."""

import socket

from petastorm_tpu_torch.fabric import protocol as P


def fetch_from_peer(endpoint, request, deadline, io_timeout_s):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.settimeout(deadline.op_timeout(io_timeout_s))
    sock.connect(endpoint)
    sock.settimeout(deadline.op_timeout(io_timeout_s))
    sock.sendall(request)
    sock.settimeout(deadline.op_timeout(io_timeout_s))
    return sock.recv(65536)


def accept_loop(listener, handle, poll_s, stop):
    while not stop.is_set():
        listener.settimeout(poll_s)
        try:
            conn, _addr = listener.accept()
        except socket.timeout:
            continue
        handle(conn)


def drain(sock, n, io_timeout_s):
    deadline = P.Deadline(10.0)
    parts = []
    while n > 0:
        sock.settimeout(deadline.op_timeout(io_timeout_s))
        part = sock.recv(min(4096, n))
        if not part:
            break
        parts.append(part)
        n -= len(part)
    return b''.join(parts)
