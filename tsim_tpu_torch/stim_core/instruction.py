"""Circuit instruction and repeat-block objects (stim API equivalents)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .gates import gate_data
from .targets import GateTarget


@dataclass
class CircuitInstruction:
    name: str
    targets: list[GateTarget] = field(default_factory=list)
    args: list[float] = field(default_factory=list)
    tag: str = ""

    def targets_copy(self) -> list[GateTarget]:
        return list(self.targets)

    def gate_args_copy(self) -> list[float]:
        return list(self.args)

    def target_groups(self) -> list[list[GateTarget]]:
        """Split targets into application groups.

        For fixed-arity gates: consecutive chunks of the arity. For
        pauli-product gates (MPP/SPP/E): combiner-separated products. For
        annotations: one group with all targets.
        """
        data = gate_data(self.name)
        if data.takes_pauli_targets:
            groups: list[list[GateTarget]] = []
            cur: list[GateTarget] = []
            expect_more = False
            for t in self.targets:
                if t.is_combiner:
                    expect_more = True
                    continue
                if expect_more or not cur:
                    cur.append(t)
                    expect_more = False
                else:
                    groups.append(cur)
                    cur = [t]
            if cur:
                groups.append(cur)
            return groups
        k = data.arity
        if k <= 0:
            return [list(self.targets)] if self.targets else []
        return [self.targets[i : i + k] for i in range(0, len(self.targets), k)]

    @property
    def num_measurements(self) -> int:
        data = gate_data(self.name)
        if not data.produces_measurements:
            return 0
        if self.name.upper() == "MPP":
            return len(self.target_groups())
        if data.arity == 2:
            return len(self.targets) // 2
        return len(self.targets)

    def __str__(self) -> str:
        out = self.name
        if self.tag:
            out += f"[{self.tag}]"
        if self.args:
            out += "(" + ", ".join(_fmt_arg(a) for a in self.args) + ")"
        if self.targets:
            data = gate_data(self.name)
            if data.takes_pauli_targets:
                parts: list[str] = []
                prev_combiner = True  # suppress leading space via join below
                toks: list[str] = []
                for t in self.targets:
                    if t.is_combiner:
                        toks.append("*")
                    else:
                        toks.append(str(t))
                # join pauli products: X0 * Y1 -> X0*Y1
                s = ""
                for i, tok in enumerate(toks):
                    if tok == "*" or (i > 0 and toks[i - 1] == "*"):
                        s += tok
                    else:
                        s += (" " if s else "") + tok
                out += " " + s
            else:
                out += " " + " ".join(str(t) for t in self.targets)
        return out

    def __repr__(self) -> str:
        return f"CircuitInstruction({self!s})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, CircuitInstruction):
            return NotImplemented
        return (
            self.name.upper() == other.name.upper()
            and self.targets == other.targets
            and self.args == other.args
            and self.tag == other.tag
        )


def _fmt_arg(a: float) -> str:
    if a == int(a) and abs(a) < 1e15:
        return str(int(a))
    return repr(a)


class CircuitRepeatBlock:
    def __init__(self, repeat_count: int, body):
        if repeat_count <= 0:
            raise ValueError("repeat count must be positive")
        self.repeat_count = repeat_count
        self._body = body.copy()

    def body_copy(self):
        return self._body.copy()

    @property
    def num_measurements(self) -> int:
        return self.repeat_count * self._body.num_measurements

    @property
    def name(self) -> str:
        return "REPEAT"

    def __str__(self) -> str:
        inner = "\n".join("    " + line for line in str(self._body).splitlines())
        return f"REPEAT {self.repeat_count} {{\n{inner}\n}}"

    def __repr__(self) -> str:
        return f"CircuitRepeatBlock({self.repeat_count}, ...)"

    def __eq__(self, other) -> bool:
        if not isinstance(other, CircuitRepeatBlock):
            return NotImplemented
        return self.repeat_count == other.repeat_count and self._body == other._body
