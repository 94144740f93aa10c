"""Result containers for similarity searches (copy of
``gpusimilarity_tpu/models/results.py``, which imports no JAX but sits in a
package whose ``__init__`` does)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SearchResult:
    """Top-k results of one query against one database (or a merged set).

    Mirrors the payload the reference returns per search
    (``gpusim.cpp:431-453``): parallel smiles/ids/scores arrays plus the
    approximate count of all library entries above the cutoff.
    """

    smiles: list[str] = field(default_factory=list)
    ids: list[str] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)
    approximate_count: int = 0
    indices: list[int] | None = None  # global row indices, when requested

    def __len__(self) -> int:
        return len(self.scores)

    def rows(self) -> list[list]:
        """JSON rows in the reference's ``[[id, smiles, score], ...]`` shape
        (``gpusim_server.py:153-168``)."""
        return [
            [i, s, float(sc)]
            for i, s, sc in zip(self.ids, self.smiles, self.scores)
        ]
