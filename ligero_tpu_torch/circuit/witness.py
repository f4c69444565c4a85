"""circom witness calculation: run the circuit's ``.wasm`` natively.

The port's own copy of ``ligero_tpu/circuit/witness.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Implements the circom-2 witness-calculator protocol (as defined by the
generated ``witness_calculator.js``, checked in with the reference's
poseidon fixture) on top of the in-tree WASM interpreter — the functional
replacement for ark-circom's wasmer execution path
(reference src/reader.rs, SURVEY.md §2.2).

Protocol:
* ``init(sanity)``; field width via ``getFieldNumLen32``; prime via
  ``getRawPrime`` + ``readSharedRWMemory``;
* per input signal: 64-bit FNV-1a hash of the name split into
  (MSB, LSB) words, each value written into shared memory as n32 LE
  u32 words, then ``setInputSignal(hMSB, hLSB, position)``;
* witness read back with ``getWitness(i)`` + shared-memory reads.
"""

from __future__ import annotations

from ..fields import FieldSpec
from ..wasm_interp import WasmModule, WasmTrap

_ERRORS = {
    1: "Signal not found.",
    2: "Too many signals set.",
    3: "Signal already set.",
    4: "Assert Failed.",
    5: "Not enough memory.",
    6: "Input signal array access exceeds the size.",
}


def _fnv1a_64(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class WitnessCalculator:
    def __init__(self, wasm_path: str):
        self._err: list[str] = []

        def exception_handler(code):
            raise WasmTrap(_ERRORS.get(code, "Unknown error.")
                           + (" " + " ".join(self._err) if self._err else ""))

        def print_error_message():
            self._err.append(self._get_message())

        imports = {"runtime": {
            "exceptionHandler": exception_handler,
            "printErrorMessage": print_error_message,
            "writeBufferMessage": lambda: None,
            "showSharedRWMemory": lambda: None,
        }}
        with open(wasm_path, "rb") as f:
            self.mod = WasmModule(f.read(), imports)
        self.n32 = self.mod.invoke("getFieldNumLen32")[0]
        self.mod.invoke("getRawPrime")
        self.prime = self._read_shared()
        self.witness_size = self.mod.invoke("getWitnessSize")[0]

    def _get_message(self) -> str:
        out = []
        while True:
            c = self.mod.invoke("getMessageChar")[0]
            if c == 0:
                return "".join(out)
            out.append(chr(c))

    def _read_shared(self) -> int:
        val = 0
        for j in reversed(range(self.n32)):
            val = (val << 32) | self.mod.invoke("readSharedRWMemory", j)[0]
        return val

    def calculate_witness(self, inputs: dict) -> list[int]:
        """``inputs``: signal name -> int or list of ints."""
        self.mod.invoke("init", 1)
        count = 0
        for name, values in inputs.items():
            if not isinstance(values, (list, tuple)):
                values = [values]
            h = _fnv1a_64(name)
            h_msb, h_lsb = h >> 32, h & 0xFFFFFFFF
            size = self.mod.invoke("getInputSignalSize", h_msb, h_lsb)[0]
            if size >= (1 << 31):  # negative i32: signal not found
                raise ValueError(f"Signal {name} not found")
            if size == 0:
                raise ValueError(f"Signal {name} not found (size 0)")
            if len(values) != size:
                raise ValueError(
                    f"Signal {name}: expected {size} values, got {len(values)}")
            for i, v in enumerate(values):
                v = int(v) % self.prime
                for j in range(self.n32):
                    self.mod.invoke("writeSharedRWMemory", j,
                                    (v >> (32 * j)) & 0xFFFFFFFF)
                self.mod.invoke("setInputSignal", h_msb, h_lsb, i)
                count += 1
        expected = self.mod.invoke("getInputSize")[0]
        if count < expected:
            raise ValueError(f"Not all inputs set: {count}/{expected}")
        out = []
        for i in range(self.witness_size):
            self.mod.invoke("getWitness", i)
            out.append(self._read_shared())
        return out


def compute_witness(wasm_path: str, inputs: dict, field: FieldSpec) -> list[int]:
    calc = WitnessCalculator(wasm_path)
    assert calc.prime == field.p, "wasm prime does not match field"
    return calc.calculate_witness(inputs)
