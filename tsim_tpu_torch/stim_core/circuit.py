"""Stim-dialect circuit: parser, canonical text, counters, structural ops.

In-house replacement for the subset of ``stim.Circuit`` that the reference
uses (parsing with tags/args/targets/REPEAT, flatten, inverse, counters,
approx_equals, slicing; see reference ``SURVEY.md`` section 2.1 row 1).
"""

from __future__ import annotations

import re
from typing import Iterable, Union

from .gates import GateData, gate_data, is_gate
from .instruction import CircuitInstruction, CircuitRepeatBlock
from .targets import (
    COMBINER,
    GateTarget,
    target_combiner,
    target_qubit,
    target_rec,
    target_sweep_bit,
    target_x,
    target_y,
    target_z,
)

_NAME_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z_0-9]*)")
_TAG_RE = re.compile(r"^\[([^\]]*)\]")
_ARGS_RE = re.compile(r"^\(([^)]*)\)")
_REC_RE = re.compile(r"^rec\[(-\d+)\]$")
_SWEEP_RE = re.compile(r"^sweep\[(\d+)\]$")

_NO_FUSE = {
    "DETECTOR",
    "OBSERVABLE_INCLUDE",
    "QUBIT_COORDS",
    "SHIFT_COORDS",
    "MPP",
    "SPP",
    "SPP_DAG",
    "E",
    "CORRELATED_ERROR",
    "ELSE_CORRELATED_ERROR",
}


def _parse_target_token(tok: str) -> list[GateTarget]:
    """Parse one whitespace-delimited target token (may contain combiners)."""
    out: list[GateTarget] = []
    parts = tok.split("*")
    for i, part in enumerate(parts):
        if i > 0:
            out.append(target_combiner())
        part = part.strip()
        if not part:
            continue  # bare '*' token handled by caller context
        invert = False
        if part.startswith("!"):
            invert = True
            part = part[1:]
        m = _REC_RE.match(part)
        if m:
            out.append(target_rec(int(m.group(1))))
            continue
        m = _SWEEP_RE.match(part)
        if m:
            out.append(target_sweep_bit(int(m.group(1))))
            continue
        if part and part[0] in "XYZ" and part[1:].isdigit():
            f = {"X": target_x, "Y": target_y, "Z": target_z}[part[0]]
            out.append(f(int(part[1:]), invert))
            continue
        if part.isdigit():
            out.append(target_qubit(int(part), invert))
            continue
        raise ValueError(f"Invalid target: '{tok}'")
    return out


def _parse_instruction_line(line: str) -> CircuitInstruction:
    m = _NAME_RE.match(line)
    if not m:
        raise ValueError(f"Could not parse line: {line!r}")
    name = m.group(1)
    rest = line[m.end() :]
    tag = ""
    mt = _TAG_RE.match(rest)
    if mt:
        tag = mt.group(1)
        rest = rest[mt.end() :]
    args: list[float] = []
    ma = _ARGS_RE.match(rest)
    if ma:
        args = [float(x) for x in ma.group(1).split(",") if x.strip()]
        rest = rest[ma.end() :]
    canonical = name.upper()
    if not is_gate(canonical):
        raise ValueError(f"Gate not found: '{name}'")
    data = gate_data(canonical)
    lo, hi = data.num_args
    if not (lo <= len(args) <= hi):
        raise ValueError(
            f"Gate {canonical} was given {len(args)} parens arguments "
            f"but takes {lo} to {hi}."
        )
    targets: list[GateTarget] = []
    for tok in rest.split():
        if tok == "*":
            targets.append(target_combiner())
        else:
            sub = _parse_target_token(tok)
            targets.extend(sub)
    # Validate grouping for fixed-arity gates.
    if data.arity == 2 and sum(1 for t in targets if not t.is_combiner) % 2 != 0:
        raise ValueError(f"Gate {canonical} needs an even number of targets: {line!r}")
    _validate_targets(canonical, data, targets, line)
    return CircuitInstruction(canonical, targets, args, tag)


def _validate_targets(name: str, data: GateData, targets, line: str) -> None:
    for t in targets:
        if t.is_pauli_target and not data.takes_pauli_targets:
            raise ValueError(f"Gate {name} doesn't take pauli targets: {line!r}")
        if t.is_combiner and not data.takes_combiners:
            raise ValueError(f"Gate {name} doesn't take combiners: {line!r}")
        if t.is_measurement_record_target and not (
            data.takes_rec_targets or data.is_annotation
        ):
            raise ValueError(f"Gate {name} doesn't take rec targets: {line!r}")
    if name == "MPAD":
        for t in targets:
            if not t.is_qubit_target or t.value not in (0, 1):
                raise ValueError(f"MPAD targets must be 0 or 1: {line!r}")


class Circuit:
    """A parsed Stim-dialect circuit (sequence of instructions/repeat blocks)."""

    def __init__(self, program_text: str = ""):
        self._items: list[Union[CircuitInstruction, CircuitRepeatBlock]] = []
        if program_text:
            self.append_from_stim_program_text(program_text)

    # -------------------------------------------------------------- parsing
    def append_from_stim_program_text(self, text: str) -> None:
        stack: list[list] = [self._items]
        repeat_counts: list[int] = []
        pending = ""
        for raw_line in text.splitlines():
            line = raw_line.split("#", 1)[0].strip()
            if not line:
                continue
            while line:
                if line.startswith("}"):
                    if len(stack) == 1:
                        raise ValueError("Unmatched '}'")
                    body_items = stack.pop()
                    count = repeat_counts.pop()
                    body = Circuit()
                    body._items = body_items
                    stack[-1].append(CircuitRepeatBlock(count, body))
                    line = line[1:].strip()
                    continue
                m = re.match(r"^REPEAT\s+(\d+)\s*\{", line)
                if m:
                    repeat_counts.append(int(m.group(1)))
                    stack.append([])
                    line = line[m.end() :].strip()
                    continue
                # find possible inline '}' (e.g. "H 0 }")
                brace = _find_top_level_brace(line)
                if brace >= 0:
                    instr_text, line = line[:brace].strip(), line[brace:]
                else:
                    instr_text, line = line, ""
                if instr_text:
                    stack[-1].append(_parse_instruction_line(instr_text))
        if len(stack) != 1:
            raise ValueError("Unterminated REPEAT block")

    # -------------------------------------------------------------- appends
    def append(
        self,
        name,
        targets: Iterable = (),
        arg=None,
        *,
        tag: str = "",
    ) -> None:
        if isinstance(name, CircuitInstruction):
            self._items.append(
                CircuitInstruction(
                    name.name, list(name.targets), list(name.args), name.tag
                )
            )
            return
        if isinstance(name, CircuitRepeatBlock):
            self._items.append(CircuitRepeatBlock(name.repeat_count, name.body_copy()))
            return
        if isinstance(name, Circuit):
            for item in name._items:
                self.append(item)
            return
        canonical = str(name).upper()
        if not is_gate(canonical):
            raise ValueError(f"Gate not found: '{name}'")
        tl: list[GateTarget] = []
        if isinstance(targets, (int, GateTarget)):
            targets = [targets]
        for t in targets:
            if isinstance(t, GateTarget):
                tl.append(t)
            elif isinstance(t, int):
                tl.append(target_qubit(t))
            else:
                raise ValueError(f"Invalid target: {t!r}")
        if arg is None:
            args: list[float] = []
        elif isinstance(arg, (int, float)):
            args = [float(arg)]
        else:
            args = [float(a) for a in arg]
        data = gate_data(canonical)
        lo, hi = data.num_args
        if not (lo <= len(args) <= hi):
            raise ValueError(
                f"Gate {canonical} was given {len(args)} parens arguments "
                f"but takes {lo} to {hi}."
            )
        _validate_targets(canonical, data, tl, f"append({name})")
        self._items.append(CircuitInstruction(canonical, tl, args, tag))

    def append_operation(self, name, targets=(), args=None, tag: str = "") -> None:
        self.append(name, targets, args, tag=tag)

    # ------------------------------------------------------------- counters
    @property
    def num_measurements(self) -> int:
        return sum(item.num_measurements for item in self._items)

    @property
    def num_detectors(self) -> int:
        n = 0
        for item in self._items:
            if isinstance(item, CircuitRepeatBlock):
                n += item.repeat_count * item.body_copy().num_detectors
            elif item.name == "DETECTOR":
                n += 1
        return n

    @property
    def num_observables(self) -> int:
        n = 0
        for item in self._items:
            if isinstance(item, CircuitRepeatBlock):
                n = max(n, item.body_copy().num_observables)
            elif item.name == "OBSERVABLE_INCLUDE":
                n = max(n, int(item.args[0]) + 1)
        return n

    @property
    def num_qubits(self) -> int:
        n = 0
        for item in self._items:
            if isinstance(item, CircuitRepeatBlock):
                n = max(n, item.body_copy().num_qubits)
            else:
                for t in item.targets:
                    if t.is_qubit_target or t.is_pauli_target:
                        if item.name == "MPAD":
                            continue
                        n = max(n, t.value + 1)
        return n

    @property
    def num_ticks(self) -> int:
        n = 0
        for item in self._items:
            if isinstance(item, CircuitRepeatBlock):
                n += item.repeat_count * item.body_copy().num_ticks
            elif item.name == "TICK":
                n += 1
        return n

    # ------------------------------------------------------------ structure
    def copy(self) -> "Circuit":
        c = Circuit()
        for item in self._items:
            c.append(item)
        return c

    def flattened(self) -> "Circuit":
        c = Circuit()
        for item in self._items:
            if isinstance(item, CircuitRepeatBlock):
                body = item.body_copy().flattened()
                for _ in range(item.repeat_count):
                    for sub in body._items:
                        c.append(sub)
            else:
                c.append(item)
        return c

    def without_noise(self) -> "Circuit":
        c = Circuit()
        for item in self._items:
            if isinstance(item, CircuitRepeatBlock):
                c._items.append(
                    CircuitRepeatBlock(item.repeat_count, item.body_copy().without_noise())
                )
                continue
            data = gate_data(item.name)
            if data.is_noise:
                if data.produces_measurements:
                    # Preserve the herald record slots as deterministic zeros.
                    pads = [target_qubit(0) for t in item.targets]
                    c.append(CircuitInstruction("MPAD", pads, [], item.tag))
                continue
            if data.produces_measurements and item.args:
                # Drop measurement flip probabilities.
                c.append(CircuitInstruction(item.name, list(item.targets), [], item.tag))
                continue
            c.append(item)
        return c

    def inverse(self) -> "Circuit":
        c = Circuit()
        for item in reversed(self._items):
            if isinstance(item, CircuitRepeatBlock):
                c._items.append(
                    CircuitRepeatBlock(item.repeat_count, item.body_copy().inverse())
                )
                continue
            data = gate_data(item.name)
            if data.is_annotation and item.name in ("TICK", "QUBIT_COORDS", "SHIFT_COORDS"):
                c.append(item)
                continue
            if data.is_unitary:
                inv = data.inverse
                assert inv is not None
                c.append(CircuitInstruction(inv, list(item.targets), list(item.args), item.tag))
                continue
            if data.is_noise:
                c.append(item)
                continue
            if item.name in ("R", "RZ"):
                c.append(CircuitInstruction("M", list(item.targets), [], item.tag))
                continue
            if item.name == "RX":
                c.append(CircuitInstruction("MX", list(item.targets), [], item.tag))
                continue
            if item.name == "RY":
                c.append(CircuitInstruction("MY", list(item.targets), [], item.tag))
                continue
            if item.name in ("M", "MZ"):
                c.append(CircuitInstruction("R", list(item.targets), [], item.tag))
                continue
            if item.name == "MX":
                c.append(CircuitInstruction("RX", list(item.targets), [], item.tag))
                continue
            if item.name == "MY":
                c.append(CircuitInstruction("RY", list(item.targets), [], item.tag))
                continue
            if item.name in ("MR", "MRZ", "MRX", "MRY"):
                c.append(item)
                continue
            raise ValueError(f"Instruction {item.name} has no inverse.")
        return c

    # ------------------------------------------------------------- equality
    def __eq__(self, other) -> bool:
        if not isinstance(other, Circuit):
            return NotImplemented
        return self._canonical_items() == other._canonical_items()

    def _canonical_items(self):
        """Fused item list used for equality/str (stim fuses adjacent gates)."""
        out: list = []
        for item in self._items:
            if (
                out
                and isinstance(item, CircuitInstruction)
                and isinstance(out[-1], CircuitInstruction)
                and item.name == out[-1].name
                and item.args == out[-1].args
                and item.tag == out[-1].tag
                and item.name not in _NO_FUSE
            ):
                prev = out[-1]
                out[-1] = CircuitInstruction(
                    prev.name, prev.targets + item.targets, prev.args, prev.tag
                )
            else:
                if isinstance(item, CircuitInstruction):
                    item = CircuitInstruction(
                        item.name, list(item.targets), list(item.args), item.tag
                    )
                out.append(item)
        return out

    def approx_equals(self, other, *, atol: float) -> bool:
        if not isinstance(other, Circuit):
            return False
        a = self._canonical_items()
        b = other._canonical_items()
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if isinstance(x, CircuitRepeatBlock) or isinstance(y, CircuitRepeatBlock):
                if not (
                    isinstance(x, CircuitRepeatBlock)
                    and isinstance(y, CircuitRepeatBlock)
                    and x.repeat_count == y.repeat_count
                    and x.body_copy().approx_equals(y.body_copy(), atol=atol)
                ):
                    return False
                continue
            if x.name != y.name or x.targets != y.targets or x.tag != y.tag:
                return False
            if len(x.args) != len(y.args):
                return False
            if any(abs(p - q) > atol for p, q in zip(x.args, y.args)):
                return False
        return True

    # ------------------------------------------------------- dunder plumbing
    def __len__(self) -> int:
        return len(self._canonical_items())

    def __getitem__(self, idx):
        items = self._canonical_items()
        if isinstance(idx, slice):
            c = Circuit()
            for item in items[idx]:
                c.append(item) if isinstance(item, CircuitInstruction) else c._items.append(item)
            return c
        return items[idx]

    def __iter__(self):
        return iter(self._canonical_items())

    def __iadd__(self, other: "Circuit") -> "Circuit":
        for item in other._items:
            self.append(item)
        return self

    def __add__(self, other: "Circuit") -> "Circuit":
        c = self.copy()
        c += other
        return c

    def __imul__(self, reps: int) -> "Circuit":
        if reps == 0:
            self._items = []
        elif reps > 1:
            body = self.copy()
            self._items = [CircuitRepeatBlock(reps, body)]
        return self

    def __mul__(self, reps: int) -> "Circuit":
        c = self.copy()
        c *= reps
        return c

    __rmul__ = __mul__

    def pop(self, index: int = -1):
        items = self._canonical_items()
        item = items[index]
        del items[index]
        self._items = items
        return item

    def __str__(self) -> str:
        return "\n".join(str(item) for item in self._canonical_items())

    def __repr__(self) -> str:
        return f"stim_core.Circuit('''\n{self}\n''')"


def _find_top_level_brace(line: str) -> int:
    return line.find("}")
