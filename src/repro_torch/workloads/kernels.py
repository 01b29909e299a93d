"""``kernel.*`` scenarios: measured-structure touch streams of the port's
Hopper kernels.

Each scenario replays the launch plan of a kernel the card runs, as the
static analyser (``repro_torch.check``) reads it from the wrapper: one Op a
CUDA block, its reads the tiles it walks and its writes the tiles it
writes, so the sweep engine prices the *actual* data movement of the
shipped kernels rather than a hand-written per-tensor stream. The
reference builds these from the Pallas kernels' BlockSpecs through JAX;
the port's come from plans in Python and need neither JAX nor a card.

Names follow the analyser's catalog: ``kernel.<kernel>.<case>``, e.g.
``kernel.flash_attention.b2s512``. The catalog holds the reference's eight
cases by name and the port's own path shapes beside them. Where a card is
present, K3's cluster is the one its launch takes on that card
(``kernels.flash_decode.launch_plan``, which loads the kernels' library);
without one the plan's own is kept, as ``check.catalog`` does.
"""
from __future__ import annotations

import torch

from repro_torch.check import catalog, streams
from repro_torch.core.trace import Trace


def case_names() -> list[str]:
    """Catalog case names (without the ``kernel.`` prefix)."""
    return catalog.case_names()


def _card_decode_cluster():
    """K3's cluster as the card in this process launches it, or ``None``."""
    if not torch.cuda.is_available():
        return None
    from repro_torch.kernels.flash_decode import launch_plan

    device = torch.cuda.current_device()
    return lambda b, h, kvh, s, d, dtype, partial: launch_plan(
        device, b, h, kvh, s, d, dtype, partial).cluster


def kernel_trace(case: str) -> Trace:
    """One catalog case's launch plans compiled to a touch stream."""
    facts = catalog.trace_case(case, decode_cluster=_card_decode_cluster())
    return streams.compile_trace(list(facts), name=f"kernel.{case}")
