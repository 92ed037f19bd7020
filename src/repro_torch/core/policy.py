"""Serving policies: the one of ``repro/core/policy.py`` that the paged
engine slice reads, copied as it is (a pure dataclass).

The paged engine's :class:`AdmissionPolicy` admits a request against free
pages minus the projected growth of the requests already running.  The rest
of that file comes with the slices that read it: ``ChunkPolicy``'s tapers
with ``FusionPolicy`` feedback (a fixed chunk size needs no policy), and the
role planner, preemption, spill, integrity and prefix policies.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Admit a request into the paged serving engine?

    Admission reasons over **free pages minus the projected growth of the
    requests already running**: each active request will still map up to
    (projection − already-mapped) pages before it finishes, and those future
    claims must stay funded or on-demand growth starts failing mid-decode.

    ``growth_reserve`` scales the projection of a request's decode budget:
    1.0 (default) projects the worst case (``prompt + max_new_tokens``),
    which makes :class:`~repro_torch.serve.paged.PagePoolExhausted`
    unreachable; < 1.0 overcommits, which only preemption makes safe.
    ``watermark_pages`` holds back a safety floor for in-flight growth.
    """

    growth_reserve: float = 1.0
    watermark_pages: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.growth_reserve <= 1.0:
            raise ValueError(
                f"growth_reserve must be in [0, 1], got {self.growth_reserve}"
            )
        if self.watermark_pages < 0:
            raise ValueError(
                f"watermark_pages must be >= 0, got {self.watermark_pages}"
            )

    def projected_pages(self, prompt_len: int, max_new_tokens: int,
                        page_size: int) -> int:
        """Pages this request is projected to map over its life.

        Counts *written* rows: generating ``g`` tokens writes ``prompt + g
        - 1`` KV rows (the final sampled token is never fed back), so at
        ``growth_reserve=1.0`` the projection equals :meth:`worst_case_pages`
        exactly."""
        projected = prompt_len + max(
            1, int(math.ceil(self.growth_reserve * max_new_tokens))
        ) - 1
        return -(-max(1, projected) // page_size)

    def worst_case_pages(self, prompt_len: int, max_new_tokens: int,
                         page_size: int) -> int:
        """Pages the request maps if it runs its *full* budget — the
        ``growth_reserve``-independent figure that permanent rejection
        tests.  Exact: the cache tops out at ``prompt + max_new - 1`` rows."""
        return -(-(prompt_len + max(1, max_new_tokens) - 1) // page_size)

    @property
    def overcommitted(self) -> bool:
        """True when admission funds less than the full decode budget —
        the regime where mid-flight exhaustion (hence preemption) is live."""
        return self.growth_reserve < 1.0

    def admit(self, *, free_pages: int, projected_growth_pages: int,
              request_pages: int) -> bool:
        """``free_pages`` from the allocator, ``projected_growth_pages`` the
        summed unmapped remainder of already-admitted requests."""
        available = free_pages - projected_growth_pages - self.watermark_pages
        return request_pages <= available
