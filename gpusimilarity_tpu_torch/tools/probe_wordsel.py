"""The bitplane search's selection chain, timed stage by stage (twin of the
repository's ``tools/probe_wordsel.py``)::

    python -m gpusimilarity_tpu_torch.tools.probe_wordsel [--rows N]
        [--fold F] [--batch B] [--k 128] [--repeats 5] [--seed 11] [--cpu_only]

On ``probe_fold_batch``'s library and queries (default 352Mi virtual rows,
fold 4, B=32) it runs kernel 1 once and keeps its outputs on the device,
then times the stages of ``parallel/sharded.bitplane_local_topk`` after it,
each through the function the search calls:

* s1: ``select_blocks``, the lowest-index top-k of the block maxima (one
  per 2048 columns) to the fetch width;
* s2: s1 and ``select_words``, the gather of those blocks' word maxima and
  their top-k;
* s3: s2 and ``rescore_words``, the gather of the selected words of the
  query's planes, the carry-save sums (``wallace_popcount_planes``), the
  scores and the column top-k: the whole chain.

The JAX tool also times ``jax.lax.approx_max_k`` on the block maxima for
comparison. PyTorch has no approximate top-k, and a library call in its
place would not be the same comparison, so its line says it is absent.

Each stage is the median of ``--repeats`` calls between CUDA events, beside
the same-run floor and the stage's own byte bound (:func:`stage_bytes` over
3.35 TB/s); one JSON line per stage, then one with the deltas and the
kernel's launches. Alone, a stage also waits for the host to launch its
small operations, which inside the search overlap the kernel before them.
``--cpu_only`` runs the plain versions on the host.
"""

from __future__ import annotations

import json
import sys

from ..ops import bitplane_phase1 as ph1
from ..parallel.sharded import rescore_words, select_blocks, select_words
from .probe_fold_batch import folded_search_setup, parse_args, stage_line
from .probe_mxu import bound


def stage_bytes(b: int, n_blocks: int, k: int, set_planes: int) -> tuple[int, int, int]:
    """The bytes stages s1, s1+s2 and s1+s2+s3 must move for ``b`` queries,
    ``n_blocks`` block maxima each, fetch width ``k`` and ``set_planes`` real
    plane entries over the batch: s1 reads the block maxima and writes the
    blocks' indices; s2 reads those blocks' word maxima and writes the
    words' indices; s3 reads each query's planes at its words and the words'
    column popcounts and writes k scores and indices."""
    k_blocks = min(k, n_blocks)
    k_words = min(k, k_blocks * ph1.BLOCK_WORDS)
    s1 = b * n_blocks * 4 + b * k_blocks * 8
    s2 = s1 + b * k_blocks * ph1.BLOCK_WORDS * 4 + b * k_words * 8
    s3 = s2 + set_planes * k_words * 4 + b * k_words * 32 * 2 + b * k * 12
    return s1, s2, s3


def main(argv=None) -> int:
    args = parse_args(argv, __doc__.splitlines()[0])
    s = folded_search_setup(args)
    ph1.reset_launch_count()
    block_max, _counts, colmax = ph1.bitplane_phase1_batched(
        s.store.planes, s.store.popcounts, s.idx, s.qpops, s.cutoffs, s.ab,
        s.store.n_valid)
    k = s.k_fetch

    def s1():
        return select_blocks(block_max, k)

    def s2():
        return select_words(colmax, s1(), k)

    def s3():
        return rescore_words(s.store, s.idx, s.qpops, s2(), k)

    set_planes = int((s.plane_idx != s.store.bitcount).sum())
    b1, b2, b3 = (bound(n) for n in stage_bytes(args.batch, block_max.shape[1], k,
                                                 set_planes))
    t1 = stage_line(s, args, "s1_select_blocks", s1, b1)
    print(json.dumps({
        "stage": "s1_approx_max_k", "absent": True,
        "reason": "PyTorch has no approximate top-k (jax.lax.approx_max_k); "
                  "no library call stands in for it",
    }), flush=True)
    t2 = stage_line(s, args, "s2_select_words", s2, b2)
    t3 = stage_line(s, args, "s3_rescore_words", s3, b3)
    print(json.dumps({
        "probe": "probe_wordsel", "rows": s.rows, "fold": args.fold,
        "batch": args.batch, "k_fetch": k, "n_blocks": block_max.shape[1],
        "s1_ms": round(t1, 4), "s2_delta_ms": round(t2 - t1, 4),
        "s3_delta_ms": round(t3 - t2, 4),
        "kernel_launches": {"bitplane_phase1": ph1.launch_count()},
        "card": s.card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
