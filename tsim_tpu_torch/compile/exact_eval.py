"""Dispatch of the exact evaluator (counterpart of ``evaluate_abs_auto``,
``evaluate_abs_fused``, ``evaluate_abs_fused_small`` and
``_combine_partials`` in ``tsim_tpu``'s ``compile/pallas_evaluate.py``).

A CPU tensor runs the plain version (``compile/evaluate.py``) on the rung
read back from its tables. A CUDA tensor runs the hand-written kernels
(``kernels/exact_eval.py``): "small" below 24 graphs, "wide" otherwise;
they raise if they cannot be built or launched. The kernels' per-tile
exact partials are summed with :class:`ExactScalarArray`, and the one
float conversion is the plain version's own code.
"""

from __future__ import annotations

import torch

from ..core.exact_scalar import ExactScalarArray, exact_magnitude
from ..kernels import exact_eval as _kernel
from .evaluate import evaluate_abs, plain_bytes_per_row
from .exact_tables import ExactTables


def combine_partials(out_c: torch.Tensor, out_p: torch.Tensor) -> torch.Tensor:
    """Exact sum of per-tile partials, (n_tiles, B, 4) and (n_tiles, B), then |.|."""
    esa = ExactScalarArray(coeffs=out_c.permute(2, 1, 0), power=out_p.T).sum(axis=-1)
    return exact_magnitude(esa.coeffs, esa.power)


def approx_magnitude(partials: torch.Tensor) -> torch.Tensor:
    """|.| of the float32 sum of per-tile (re, im) partials, (n_tiles, B, 2)."""
    total = partials.sum(dim=0)
    return torch.sqrt(total[:, 0] ** 2 + total[:, 1] ** 2)


def bytes_per_row(tables: ExactTables, device: torch.device) -> int:
    """Bytes a row that :func:`evaluate_abs_exact` holds at its peak on
    ``device``, its (B,) float32 result included. On a card, with n the
    kernels' tiles: the approximate finisher's (n, B, 2) float32 partials,
    their (B, 2) sum and :func:`approx_magnitude`'s temporaries (8n + 20);
    the exact one's (n, B, 4) and (n, B) int32 partials (20n), the first
    level of :func:`combine_partials`' aligned-add tree (two shifted Z[w]
    products of a pair of tiles, their sum, its reduce step's shifted copy
    and masks: 33 bytes a tile) and the one float conversion (36). On the
    CPU, the plain version's (``compile/evaluate.py::plain_bytes_per_row``)."""
    if device.type == "cpu":
        return plain_bytes_per_row(tables.dims, tables.n_params, tables.num_graphs)
    n = _kernel.num_tiles(tables.num_graphs)
    return 8 * n + 20 if tables.approximate else 53 * n + 36


def evaluate_abs_exact(tables: ExactTables, x: torch.Tensor) -> torch.Tensor:
    """|amplitude| per row of one rung: (B, P) uint8 -> (B,) float32."""
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != tables.n_params:
        raise ValueError(
            f"expected (B, {tables.n_params}) uint8 parameter rows, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if tables.num_graphs == 0 or x.shape[0] == 0:
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return evaluate_abs(tables.circuit(), x)
    x = x.contiguous()
    if tables.approximate:
        return approx_magnitude(_kernel.approx_partials(tables, x))
    return combine_partials(*_kernel.exact_partials(tables, x))
