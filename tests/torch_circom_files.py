"""Writers of circom's binary files for the port's tests: an ``.r1cs`` and a
``.wtns`` in the iden3 layouts, and the witness ``.json``, made from plain
data so that no test needs a file from outside the repository."""

import json
import struct


def r1cs_bytes(p: int, num_instance: int, num_witness: int, a, b, c) -> bytes:
    """iden3 ``.r1cs`` of the rows ``a``, ``b``, ``c`` (lists of
    ``(coefficient, wire)`` terms): header, constraints, wire-to-label map."""
    fs = 32 if p < 1 << 256 else 48
    n_wires = num_instance + num_witness
    header = (struct.pack("<I", fs) + p.to_bytes(fs, "little")
              + struct.pack("<IIII", n_wires, num_instance - 1, 0, num_witness)
              + struct.pack("<Q", n_wires) + struct.pack("<I", len(a)))
    body = b""
    for rows in zip(a, b, c):
        for row in rows:
            body += struct.pack("<I", len(row))
            for coeff, wire in row:
                body += struct.pack("<I", wire) + (coeff % p).to_bytes(fs, "little")
    labels = b"".join(struct.pack("<Q", i) for i in range(n_wires))
    out = b"r1cs" + struct.pack("<II", 1, 3)
    for kind, data in ((1, header), (2, body), (3, labels)):
        out += struct.pack("<IQ", kind, len(data)) + data
    return out


def wtns_bytes(p: int, values) -> bytes:
    fs = 32 if p < 1 << 256 else 48
    header = struct.pack("<I", fs) + p.to_bytes(fs, "little") + struct.pack(
        "<I", len(values))
    data = b"".join((v % p).to_bytes(fs, "little") for v in values)
    out = b"wtns" + struct.pack("<II", 2, 2)
    for kind, blob in ((1, header), (2, data)):
        out += struct.pack("<IQ", kind, len(blob)) + blob
    return out


def write_cs(path, cs) -> str:
    """A constraint system of either package -> an ``.r1cs`` file."""
    with open(path, "wb") as f:
        f.write(r1cs_bytes(cs.field.p, cs.num_instance, cs.num_witness,
                           cs.a, cs.b, cs.c))
    return str(path)


def write_wtns(path, p: int, values) -> str:
    with open(path, "wb") as f:
        f.write(wtns_bytes(p, values))
    return str(path)


def write_witness_json(path, values) -> str:
    with open(path, "w") as f:
        json.dump([str(v) for v in values], f)
    return str(path)


def multiplication(p: int):
    """circom's ``multiplication`` example as plain rows: wires
    [1, y, s1, s2] and the constraint s1 * s2 = y (y public)."""
    return dict(num_instance=2, num_witness=2, a=[[(1, 2)]], b=[[(1, 3)]],
                c=[[(1, 1)]])


def multiplication_witness(i: int = 0) -> list[int]:
    s1, s2 = 3 + i, 5 + 2 * i
    return [1, s1 * s2, s1, s2]
