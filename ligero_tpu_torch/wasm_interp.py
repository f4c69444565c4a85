"""Minimal WebAssembly (MVP, integer-only) interpreter.

The port's own copy of ``ligero_tpu/wasm_interp.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Exists to execute circom witness-calculator ``.wasm`` modules — the
reference runs them under wasmer/cranelift via ark-circom
(reference src/reader.rs, flamegraph evidence SURVEY.md §2.2).
This environment has no WASM runtime, so a small pure-Python interpreter
covers the instruction profile circom's code generator emits: linear
memory, i32/i64 arithmetic, structured control flow, direct and indirect
calls.  Float opcodes raise (circom witness code is integer-only).

Function bodies are pre-decoded once into flat instruction lists with
block structure (end/else targets) resolved, so execution is a simple
dispatch loop over tuples.
"""

from __future__ import annotations

import struct


def _leb_u(data: bytes, pos: int) -> tuple[int, int]:
    r = s = 0
    while True:
        b = data[pos]; pos += 1
        r |= (b & 0x7F) << s
        s += 7
        if not b & 0x80:
            return r, pos


def _leb_s(data: bytes, pos: int, bits: int) -> tuple[int, int]:
    r = s = 0
    while True:
        b = data[pos]; pos += 1
        r |= (b & 0x7F) << s
        s += 7
        if not b & 0x80:
            if s < bits and (b & 0x40):
                r |= -(1 << s)
            return r, pos


MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _trunc_rem(a: int, b: int) -> int:
    return a - b * _trunc_div(a, b)


def _s32(x):
    return x - (1 << 32) if x & 0x80000000 else x


def _s64(x):
    return x - (1 << 64) if x & 0x8000000000000000 else x


class WasmTrap(RuntimeError):
    pass


class _Func:
    __slots__ = ("type_idx", "n_params", "n_results", "locals", "code")

    def __init__(self, type_idx, n_params, n_results, locals_, code):
        self.type_idx = type_idx
        self.n_params = n_params
        self.n_results = n_results
        self.locals = locals_
        self.code = code


class WasmModule:
    def __init__(self, binary: bytes, imports: dict):
        self.types: list[tuple[int, int]] = []  # (n_params, n_results)
        self.funcs: list = []      # imported callables then _Func entries
        self.n_imported = 0
        self.exports: dict[str, tuple[int, int]] = {}
        self.table: list[int | None] = []
        self.memory = bytearray()
        self.globals: list[int] = []
        self._parse(binary, imports)

    # ------------------------------------------------------------------
    def _parse(self, data: bytes, imports: dict):
        assert data[:4] == b"\0asm", "bad wasm magic"
        pos = 8
        func_type_indices: list[int] = []
        code_bodies: list[tuple[bytes, int]] = []
        while pos < len(data):
            sec_id = data[pos]; pos += 1
            size, pos = _leb_u(data, pos)
            body = data[pos:pos + size]
            pos += size
            if sec_id == 1:      # types
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    assert body[p] == 0x60
                    p += 1
                    np_, p = _leb_u(body, p); p += np_
                    nr, p = _leb_u(body, p); p += nr
                    self.types.append((np_, nr))
            elif sec_id == 2:    # imports
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    ml, p = _leb_u(body, p); mod = body[p:p + ml].decode(); p += ml
                    nl, p = _leb_u(body, p); name = body[p:p + nl].decode(); p += nl
                    kind = body[p]; p += 1
                    assert kind == 0, "only function imports supported"
                    ti, p = _leb_u(body, p)
                    fn = imports[mod][name]
                    self.funcs.append(("import", ti, fn))
                self.n_imported = len(self.funcs)
            elif sec_id == 3:    # function declarations
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    ti, p = _leb_u(body, p)
                    func_type_indices.append(ti)
            elif sec_id == 4:    # table
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    assert body[p] == 0x70
                    p += 1
                    flags, p = _leb_u(body, p)
                    mn, p = _leb_u(body, p)
                    if flags:
                        _, p = _leb_u(body, p)
                    self.table = [None] * mn
            elif sec_id == 5:    # memory
                cnt, p = _leb_u(body, 0)
                flags, p = _leb_u(body, p)
                mn, p = _leb_u(body, p)
                if flags:
                    _, p = _leb_u(body, p)
                self.memory = bytearray(mn * 65536)
            elif sec_id == 6:    # globals
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    p += 2  # valtype, mutability
                    op = body[p]; p += 1
                    if op == 0x41:
                        v, p = _leb_s(body, p, 32)
                    elif op == 0x42:
                        v, p = _leb_s(body, p, 64)
                    else:
                        raise WasmTrap(f"unsupported global init op {op:#x}")
                    assert body[p] == 0x0B
                    p += 1
                    self.globals.append(v & MASK64)
            elif sec_id == 7:    # exports
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    nl, p = _leb_u(body, p); name = body[p:p + nl].decode(); p += nl
                    kind = body[p]; p += 1
                    idx, p = _leb_u(body, p)
                    self.exports[name] = (kind, idx)
            elif sec_id == 9:    # elements
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    flags, p = _leb_u(body, p)
                    assert flags == 0, "only active elem segments"
                    assert body[p] == 0x41
                    p += 1
                    off, p = _leb_s(body, p, 32)
                    assert body[p] == 0x0B
                    p += 1
                    n, p = _leb_u(body, p)
                    for i in range(n):
                        fi, p = _leb_u(body, p)
                        self.table[off + i] = fi
            elif sec_id == 10:   # code
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    sz, p = _leb_u(body, p)
                    code_bodies.append((body[p:p + sz], 0))
                    p += sz
            elif sec_id == 11:   # data
                cnt, p = _leb_u(body, 0)
                for _ in range(cnt):
                    flags, p = _leb_u(body, p)
                    assert flags == 0
                    assert body[p] == 0x41
                    p += 1
                    off, p = _leb_s(body, p, 32)
                    assert body[p] == 0x0B
                    p += 1
                    n, p = _leb_u(body, p)
                    self.memory[off:off + n] = body[p:p + n]
                    p += n
            # ignore custom (0) and others

        for ti, (raw, _) in zip(func_type_indices, code_bodies):
            n_params, n_results = self.types[ti]
            p = 0
            nloc, p = _leb_u(raw, p)
            locals_ = 0
            for _ in range(nloc):
                c, p = _leb_u(raw, p)
                p += 1  # valtype
                locals_ += c
            code = _decode(raw, p)
            self.funcs.append(_Func(ti, n_params, n_results, locals_, code))

    # ------------------------------------------------------------------
    def invoke(self, name: str, *args):
        kind, idx = self.exports[name]
        assert kind == 0
        return self._call(idx, list(args))

    def _call(self, fidx: int, args: list[int]):
        f = self.funcs[fidx]
        if isinstance(f, tuple):  # host import
            res = f[2](*args)
            return [] if res is None else [res & MASK64]
        frame_locals = args + [0] * f.locals
        return _exec(self, f, frame_locals)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

# ops with a single u-LEB immediate
_U_IMM = {0x0C, 0x0D, 0x10, 0x20, 0x21, 0x22, 0x23, 0x24, 0x3F, 0x40}
_MEM_OPS = set(range(0x28, 0x3F))


def _decode(raw: bytes, p: int) -> list[tuple]:
    """Flat decode with block structure resolved.

    Each entry: (op, imm) where imm depends on op; block/loop/if entries are
    (op, end_idx, else_idx_or_None, arity).
    """
    out: list[list] = []
    stack: list[int] = []
    while p < len(raw):
        op = raw[p]; p += 1
        if op in (0x02, 0x03, 0x04):  # block, loop, if
            bt = raw[p]; p += 1
            arity = 0 if bt == 0x40 else 1
            out.append([op, None, None, arity])
            stack.append(len(out) - 1)
        elif op == 0x05:  # else
            bi = stack[-1]
            out.append([0x05, None])
            out[bi][2] = len(out) - 1
        elif op == 0x0B:  # end
            if stack:
                bi = stack.pop()
                out.append([0x0B, None])
                out[bi][1] = len(out) - 1
                if out[bi][0] == 0x04 and out[bi][2] is not None:
                    out[out[bi][2]][1] = out[bi][1]
            else:
                out.append([0x0B, None])  # function end
        elif op == 0x0E:  # br_table
            n, p = _leb_u(raw, p)
            targets = []
            for _ in range(n):
                t, p = _leb_u(raw, p)
                targets.append(t)
            d, p = _leb_u(raw, p)
            out.append([op, targets, d])
        elif op == 0x11:  # call_indirect
            ti, p = _leb_u(raw, p)
            p += 1  # table index (0)
            out.append([op, ti])
        elif op == 0x41:
            v, p = _leb_s(raw, p, 32)
            out.append([op, v & MASK32])
        elif op == 0x42:
            v, p = _leb_s(raw, p, 64)
            out.append([op, v & MASK64])
        elif op in (0x43, 0x44):
            raise WasmTrap("float constants unsupported")
        elif op in _MEM_OPS:
            _, p = _leb_u(raw, p)   # align
            off, p = _leb_u(raw, p)
            out.append([op, off])
        elif op in _U_IMM:
            v, p = _leb_u(raw, p)
            out.append([op, v])
        elif op == 0xFC:  # bulk-memory prefix
            sub, p = _leb_u(raw, p)
            if sub == 10:      # memory.copy: two reserved bytes
                p += 2
            elif sub == 11:    # memory.fill: one reserved byte
                p += 1
            else:
                raise WasmTrap(f"unsupported 0xFC sub-op {sub}")
            out.append([0xFC, sub])
        else:
            out.append([op, None])
    return [tuple(e) for e in out]


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _exec(mod: WasmModule, f: _Func, locals_: list[int]):
    code = f.code
    mem = mod.memory
    stack: list[int] = []
    # control frames: (kind_op, end_idx, start_idx, stack_base, arity)
    ctrl: list[tuple] = [(0x02, len(code) - 1, 0, 0, f.n_results)]
    ip = 0

    def do_branch(depth: int) -> int:
        nonlocal ctrl
        frame = ctrl[len(ctrl) - 1 - depth]
        ctrl = ctrl[:len(ctrl) - depth]
        kind, end_idx, start_idx, base, arity = frame
        if kind == 0x03:  # loop: jump to its start, keep the frame
            del stack[base:]
            return start_idx
        vals = stack[len(stack) - arity:] if arity else []
        del stack[base:]
        stack.extend(vals)
        ctrl.pop()
        return end_idx

    while ip < len(code):
        entry = code[ip]
        op = entry[0]

        if op == 0x20:    # local.get
            stack.append(locals_[entry[1]])
        elif op == 0x21:  # local.set
            locals_[entry[1]] = stack.pop()
        elif op == 0x22:  # local.tee
            locals_[entry[1]] = stack[-1]
        elif op == 0x41 or op == 0x42:  # const
            stack.append(entry[1])
        elif op == 0x02 or op == 0x03:  # block / loop
            ctrl.append((op, entry[1], ip, len(stack), entry[3]))
        elif op == 0x04:  # if
            cond = stack.pop()
            ctrl.append((op, entry[1], ip, len(stack), entry[3]))
            if not cond:
                ip = entry[2] if entry[2] is not None else entry[1]
                if entry[2] is None:
                    ctrl.pop()
        elif op == 0x05:  # else: reached only by fallthrough from then-branch
            frame = ctrl.pop()
            ip = frame[1]
        elif op == 0x0B:  # end
            if ctrl and ctrl[-1][1] == ip:
                ctrl.pop()
        elif op == 0x0C:  # br
            ip = do_branch(entry[1])
        elif op == 0x0D:  # br_if
            if stack.pop():
                ip = do_branch(entry[1])
        elif op == 0x0E:  # br_table
            i = stack.pop()
            targets, default = entry[1], entry[2]
            ip = do_branch(targets[i] if i < len(targets) else default)
        elif op == 0x0F:  # return
            return stack[len(stack) - f.n_results:] if f.n_results else []
        elif op == 0x10:  # call
            callee = mod.funcs[entry[1]]
            if isinstance(callee, tuple):
                res = callee[2](*(
                    [stack.pop() for _ in range(mod.types[callee[1]][0])][::-1]))
                if mod.types[callee[1]][1]:
                    stack.append(res & MASK64)
            else:
                nargs = callee.n_params
                args = stack[len(stack) - nargs:]
                del stack[len(stack) - nargs:]
                stack.extend(mod._call(entry[1], args))
        elif op == 0x11:  # call_indirect
            elem = stack.pop()
            fidx = mod.table[elem]
            if fidx is None:
                raise WasmTrap("uninitialized table element")
            callee = mod.funcs[fidx]
            nargs = callee.n_params if isinstance(callee, _Func) \
                else mod.types[callee[1]][0]
            args = stack[len(stack) - nargs:]
            del stack[len(stack) - nargs:]
            stack.extend(mod._call(fidx, args))
        elif op == 0x1A:  # drop
            stack.pop()
        elif op == 0x1B:  # select
            c = stack.pop(); b = stack.pop(); a = stack.pop()
            stack.append(a if c else b)
        elif op == 0x23:  # global.get
            stack.append(mod.globals[entry[1]])
        elif op == 0x24:  # global.set
            mod.globals[entry[1]] = stack.pop()
        # ---- memory loads
        elif op == 0x28:  # i32.load
            a = stack.pop() + entry[1]
            stack.append(int.from_bytes(mem[a:a + 4], "little"))
        elif op == 0x29:  # i64.load
            a = stack.pop() + entry[1]
            stack.append(int.from_bytes(mem[a:a + 8], "little"))
        elif op == 0x2C:  # i32.load8_s
            a = stack.pop() + entry[1]
            stack.append((mem[a] - 256 if mem[a] & 0x80 else mem[a]) & MASK32)
        elif op == 0x2D:  # i32.load8_u
            a = stack.pop() + entry[1]
            stack.append(mem[a])
        elif op == 0x2E:  # i32.load16_s
            a = stack.pop() + entry[1]
            v = int.from_bytes(mem[a:a + 2], "little")
            stack.append((v - 65536 if v & 0x8000 else v) & MASK32)
        elif op == 0x2F:  # i32.load16_u
            a = stack.pop() + entry[1]
            stack.append(int.from_bytes(mem[a:a + 2], "little"))
        elif op == 0x30:  # i64.load8_s
            a = stack.pop() + entry[1]
            stack.append((mem[a] - 256 if mem[a] & 0x80 else mem[a]) & MASK64)
        elif op == 0x31:  # i64.load8_u
            a = stack.pop() + entry[1]
            stack.append(mem[a])
        elif op == 0x32:  # i64.load16_s
            a = stack.pop() + entry[1]
            v = int.from_bytes(mem[a:a + 2], "little")
            stack.append((v - 65536 if v & 0x8000 else v) & MASK64)
        elif op == 0x33:  # i64.load16_u
            a = stack.pop() + entry[1]
            stack.append(int.from_bytes(mem[a:a + 2], "little"))
        elif op == 0x34:  # i64.load32_s
            a = stack.pop() + entry[1]
            v = int.from_bytes(mem[a:a + 4], "little")
            stack.append((v - (1 << 32) if v & 0x80000000 else v) & MASK64)
        elif op == 0x35:  # i64.load32_u
            a = stack.pop() + entry[1]
            stack.append(int.from_bytes(mem[a:a + 4], "little"))
        # ---- memory stores
        elif op == 0x36:  # i32.store
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a:a + 4] = (v & MASK32).to_bytes(4, "little")
        elif op == 0x37:  # i64.store
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a:a + 8] = (v & MASK64).to_bytes(8, "little")
        elif op == 0x3A:  # i32.store8
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a] = v & 0xFF
        elif op == 0x3B:  # i32.store16
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a:a + 2] = (v & 0xFFFF).to_bytes(2, "little")
        elif op == 0x3C:  # i64.store8
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a] = v & 0xFF
        elif op == 0x3D:  # i64.store16
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a:a + 2] = (v & 0xFFFF).to_bytes(2, "little")
        elif op == 0x3E:  # i64.store32
            v = stack.pop(); a = stack.pop() + entry[1]
            mem[a:a + 4] = (v & MASK32).to_bytes(4, "little")
        elif op == 0x3F:  # memory.size
            stack.append(len(mem) // 65536)
        elif op == 0x40:  # memory.grow
            pages = stack.pop()
            old = len(mem) // 65536
            mem.extend(bytearray(pages * 65536))
            stack.append(old)
        # ---- i32 tests/compares
        elif op == 0x45:
            stack.append(1 if stack.pop() == 0 else 0)
        elif 0x46 <= op <= 0x4F:
            b = stack.pop(); a = stack.pop()
            sa, sb = _s32(a), _s32(b)
            stack.append(1 if (
                (op == 0x46 and a == b) or (op == 0x47 and a != b)
                or (op == 0x48 and sa < sb) or (op == 0x49 and a < b)
                or (op == 0x4A and sa > sb) or (op == 0x4B and a > b)
                or (op == 0x4C and sa <= sb) or (op == 0x4D and a <= b)
                or (op == 0x4E and sa >= sb) or (op == 0x4F and a >= b)
            ) else 0)
        elif op == 0x50:
            stack.append(1 if stack.pop() == 0 else 0)
        elif 0x51 <= op <= 0x5A:
            b = stack.pop(); a = stack.pop()
            sa, sb = _s64(a), _s64(b)
            stack.append(1 if (
                (op == 0x51 and a == b) or (op == 0x52 and a != b)
                or (op == 0x53 and sa < sb) or (op == 0x54 and a < b)
                or (op == 0x55 and sa > sb) or (op == 0x56 and a > b)
                or (op == 0x57 and sa <= sb) or (op == 0x58 and a <= b)
                or (op == 0x59 and sa >= sb) or (op == 0x5A and a >= b)
            ) else 0)
        # ---- i32 arithmetic
        elif op == 0x67:  # clz
            v = stack.pop()
            stack.append(32 - v.bit_length() if v else 32)
        elif op == 0x68:  # ctz
            v = stack.pop()
            stack.append((v & -v).bit_length() - 1 if v else 32)
        elif op == 0x69:  # popcnt
            stack.append(bin(stack.pop()).count("1"))
        elif 0x6A <= op <= 0x78:
            b = stack.pop(); a = stack.pop()
            if op == 0x6A:
                r = a + b
            elif op == 0x6B:
                r = a - b
            elif op == 0x6C:
                r = a * b
            elif op == 0x6D:  # div_s
                if b == 0:
                    raise WasmTrap("division by zero")
                r = _trunc_div(_s32(a), _s32(b))
            elif op == 0x6E:  # div_u
                if b == 0:
                    raise WasmTrap("division by zero")
                r = a // b
            elif op == 0x6F:  # rem_s
                if b == 0:
                    raise WasmTrap("division by zero")
                r = _trunc_rem(_s32(a), _s32(b))
            elif op == 0x70:  # rem_u
                if b == 0:
                    raise WasmTrap("division by zero")
                r = a % b
            elif op == 0x71:
                r = a & b
            elif op == 0x72:
                r = a | b
            elif op == 0x73:
                r = a ^ b
            elif op == 0x74:
                r = a << (b & 31)
            elif op == 0x75:
                r = _s32(a) >> (b & 31)
            elif op == 0x76:
                r = a >> (b & 31)
            elif op == 0x77:  # rotl
                s = b & 31
                r = (a << s) | (a >> (32 - s)) if s else a
            else:             # rotr
                s = b & 31
                r = (a >> s) | (a << (32 - s)) if s else a
            stack.append(r & MASK32)
        # ---- i64 arithmetic
        elif op == 0x79:  # clz
            v = stack.pop()
            stack.append(64 - v.bit_length() if v else 64)
        elif op == 0x7A:  # ctz
            v = stack.pop()
            stack.append((v & -v).bit_length() - 1 if v else 64)
        elif op == 0x7B:
            stack.append(bin(stack.pop()).count("1"))
        elif 0x7C <= op <= 0x8A:
            b = stack.pop(); a = stack.pop()
            if op == 0x7C:
                r = a + b
            elif op == 0x7D:
                r = a - b
            elif op == 0x7E:
                r = a * b
            elif op == 0x7F:
                if b == 0:
                    raise WasmTrap("division by zero")
                r = _trunc_div(_s64(a), _s64(b))
            elif op == 0x80:
                if b == 0:
                    raise WasmTrap("division by zero")
                r = a // b
            elif op == 0x81:
                if b == 0:
                    raise WasmTrap("division by zero")
                r = _trunc_rem(_s64(a), _s64(b))
            elif op == 0x82:
                if b == 0:
                    raise WasmTrap("division by zero")
                r = a % b
            elif op == 0x83:
                r = a & b
            elif op == 0x84:
                r = a | b
            elif op == 0x85:
                r = a ^ b
            elif op == 0x86:
                r = a << (b & 63)
            elif op == 0x87:
                r = _s64(a) >> (b & 63)
            elif op == 0x88:
                r = a >> (b & 63)
            elif op == 0x89:
                s = b & 63
                r = (a << s) | (a >> (64 - s)) if s else a
            else:
                s = b & 63
                r = (a >> s) | (a << (64 - s)) if s else a
            stack.append(r & MASK64)
        # ---- conversions
        elif op == 0xA7:  # i32.wrap_i64
            stack.append(stack.pop() & MASK32)
        elif op == 0xAC:  # i64.extend_i32_s
            stack.append(_s32(stack.pop()) & MASK64)
        elif op == 0xAD:  # i64.extend_i32_u
            stack.append(stack.pop() & MASK32)
        elif op == 0xC0:  # i32.extend8_s
            v = stack.pop() & 0xFF
            stack.append((v - 256 if v & 0x80 else v) & MASK32)
        elif op == 0xC1:  # i32.extend16_s
            v = stack.pop() & 0xFFFF
            stack.append((v - 65536 if v & 0x8000 else v) & MASK32)
        elif op == 0xC2:  # i64.extend8_s
            v = stack.pop() & 0xFF
            stack.append((v - 256 if v & 0x80 else v) & MASK64)
        elif op == 0xC3:  # i64.extend16_s
            v = stack.pop() & 0xFFFF
            stack.append((v - 65536 if v & 0x8000 else v) & MASK64)
        elif op == 0xC4:  # i64.extend32_s
            v = stack.pop() & MASK32
            stack.append((v - (1 << 32) if v & 0x80000000 else v) & MASK64)
        elif op == 0xFC:
            if entry[1] == 10:   # memory.copy
                n = stack.pop(); src = stack.pop(); dst = stack.pop()
                mem[dst:dst + n] = bytes(mem[src:src + n])
            else:                # memory.fill
                n = stack.pop(); val = stack.pop(); dst = stack.pop()
                mem[dst:dst + n] = bytes([val & 0xFF]) * n
        elif op == 0x00:  # unreachable
            raise WasmTrap("unreachable")
        elif op == 0x01:  # nop
            pass
        else:
            raise WasmTrap(f"unsupported opcode {op:#x} at {ip}")
        ip += 1

    return stack[len(stack) - f.n_results:] if f.n_results else []
