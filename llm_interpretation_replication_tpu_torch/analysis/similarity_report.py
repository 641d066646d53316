"""Prompt-similarity report: validate rephrasings against originals.

Rebuild of calculate_prompt_similarity.py:209-343: run the similarity engine
over every scenario of perturbations.json and write the
``original_vs_rephrasings_similarity.xlsx`` summary workbook.

A copy of the JAX package's module; the summary is a row list.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from ..stats.similarity import calculate_all_similarities
from ..utils import frame
from ..utils.xlsx import write_xlsx


def load_embedding_model(name: str = "all-MiniLM-L6-v2", log=print):
    """Optional sentence-transformers embedding model, gated exactly like
    the reference (calculate_prompt_similarity.py:26-32, 221-231): None
    when the package is missing or the model cannot load (e.g. zero-egress
    environments), with a warning — the report then runs without the
    ``embedding_cosine_similarity`` column, never fails."""
    try:
        from sentence_transformers import SentenceTransformer
    except ImportError:
        log("Warning: sentence-transformers not available. "
            "Embedding similarity will be skipped.")
        return None
    import socket

    prev_timeout = socket.getdefaulttimeout()
    try:
        # Zero-egress environments HANG on the hub download rather than
        # erroring (even under huggingface_hub's own 10 s request
        # timeouts, which cover the HTTP layer but not every socket the
        # load opens); a socket-level timeout turns that into the
        # reference's warn-and-continue path within seconds instead of
        # minutes.  setdefaulttimeout is PROCESS-GLOBAL: for the duration
        # of this load, sockets opened by other threads inherit the 10 s
        # timeout too.  Every caller of this loader (the `similarity
        # --embeddings` CLI leg and similarity_report) is single-threaded,
        # so nothing else opens sockets while it runs; the previous value
        # is restored on exit either way.
        socket.setdefaulttimeout(10.0)
        log(f"Loading embedding model: {name}")
        return SentenceTransformer(name)
    except Exception as err:
        log(f"Warning: Could not load embedding model: {err}")
        log("Continuing without embedding similarity...")
        return None
    finally:
        socket.setdefaulttimeout(prev_timeout)


def similarity_report(
    perturbation_records: Sequence[Dict],
    output_dir: str,
    max_rephrasings: Optional[int] = None,
    embedding_model=None,
) -> List[Dict]:
    """Per-scenario similarity summary -> Excel + per-pair CSVs (the
    summary's rows, as its DataFrame holds them)."""
    os.makedirs(output_dir, exist_ok=True)
    summary_rows: List[Dict] = []
    for idx, record in enumerate(perturbation_records):
        rephrasings = record["rephrasings"]
        if max_rephrasings:
            rephrasings = rephrasings[:max_rephrasings]
        if not rephrasings:
            continue
        result = calculate_all_similarities(
            record["original_main"], rephrasings, embedding_model=embedding_model
        )
        frame.write_csv(
            *frame.records(result["original_vs_rephrasings"]),
            os.path.join(output_dir, f"scenario_{idx + 1}_original_vs_rephrasings.csv"),
        )
        for metric, stats in result["summary_stats"].items():
            summary_rows.append(
                {
                    "scenario": idx + 1,
                    "metric": metric,
                    "n_rephrasings": len(rephrasings),
                    **{f"orig_{k}": v for k, v in stats["original_vs_rephrasings"].items()},
                    **{f"pair_{k}": v for k, v in stats["pairwise_rephrasings"].items()},
                }
            )
    columns, summary = frame.records(summary_rows)
    write_xlsx(columns, summary,
               os.path.join(output_dir, "original_vs_rephrasings_similarity.xlsx"))
    return summary
