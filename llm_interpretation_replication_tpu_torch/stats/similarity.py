"""Prompt-similarity validator (rephrasings stay close to their originals).

Behavioral replica of calculate_prompt_similarity.py:76-207 with an in-package
Okapi BM25 (rank_bm25 is not in this image) and the native C Levenshtein
kernel; sentence-transformer embeddings stay optional/gated exactly like the
reference.
"""

from __future__ import annotations

import math
from collections import Counter
from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..native import normalized_levenshtein_similarity


def tfidf_cosine_matrix(texts: Sequence[str]) -> np.ndarray:
    from sklearn.feature_extraction.text import TfidfVectorizer
    from sklearn.metrics.pairwise import cosine_similarity

    vec = TfidfVectorizer()
    tfidf = vec.fit_transform(list(texts))
    return cosine_similarity(tfidf)


class BM25Okapi:
    """Okapi BM25 (k1=1.5, b=0.75, rank_bm25-compatible idf with floor)."""

    def __init__(self, corpus: Sequence[Sequence[str]], k1: float = 1.5,
                 b: float = 0.75, epsilon: float = 0.25):
        self.k1 = k1
        self.b = b
        self.corpus = [list(doc) for doc in corpus]
        self.doc_len = [len(doc) for doc in self.corpus]
        self.avgdl = sum(self.doc_len) / max(len(self.corpus), 1)
        self.doc_freqs: List[Counter] = [Counter(doc) for doc in self.corpus]
        df: Counter = Counter()
        for counts in self.doc_freqs:
            df.update(counts.keys())
        n = len(self.corpus)
        # rank_bm25's idf: log((N - df + 0.5)/(df + 0.5)); negative idfs are
        # replaced by epsilon * average idf, where the average runs over ALL
        # terms (negative contributions included in both sum and count —
        # rank_bm25 BM25Okapi._calc_idf exactly; pinned bit-exact against the
        # reference's recorded similarity workbook in
        # tests/test_published_regression.py)
        idf = {}
        negative = []
        total = 0.0
        for term, freq in df.items():
            v = math.log((n - freq + 0.5) / (freq + 0.5))
            idf[term] = v
            total += v
            if v < 0:
                negative.append(term)
        avg_idf = total / max(len(idf), 1)
        for term in negative:
            idf[term] = epsilon * avg_idf
        self.idf = idf

    def get_scores(self, query: Sequence[str]) -> np.ndarray:
        scores = np.zeros(len(self.corpus))
        for term in query:
            idf = self.idf.get(term)
            if idf is None:
                continue
            for i, counts in enumerate(self.doc_freqs):
                f = counts.get(term, 0)
                if not f:
                    continue
                denom = f + self.k1 * (1 - self.b + self.b * self.doc_len[i] / self.avgdl)
                scores[i] += idf * f * (self.k1 + 1) / denom
        return scores


def bm25_similarity_matrix(texts: Sequence[str]) -> np.ndarray:
    tokenized = [t.lower().split() for t in texts]
    bm25 = BM25Okapi(tokenized)
    sim = np.zeros((len(texts), len(texts)))
    for i, query in enumerate(tokenized):
        scores = bm25.get_scores(query)
        max_score = scores.max() if scores.max() > 0 else 1.0
        sim[i] = scores / max_score
    return (sim + sim.T) / 2


def levenshtein_similarity_matrix(texts: Sequence[str]) -> np.ndarray:
    n = len(texts)
    sim = np.zeros((n, n))
    for i in range(n):
        sim[i, i] = 1.0
        for j in range(i + 1, n):
            s = normalized_levenshtein_similarity(texts[i], texts[j])
            sim[i, j] = sim[j, i] = s
    return sim


def calculate_all_similarities(
    original: str,
    rephrasings: Sequence[str],
    embedding_model=None,
) -> Dict:
    """Original-vs-rephrasings + pairwise similarities and summary stats."""
    all_texts = [original] + list(rephrasings)
    if embedding_model is not None:
        emb = embedding_model.encode(all_texts)
        emb = np.asarray(emb)
        norm = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        embedding_sim = norm @ norm.T
    else:
        embedding_sim = None
    tfidf_sim = tfidf_cosine_matrix(all_texts)
    bm25_sim = bm25_similarity_matrix(all_texts)
    lev_sim = levenshtein_similarity_matrix(all_texts)

    def record(i, j):
        rec = {
            "tfidf_cosine_similarity": float(tfidf_sim[i, j]),
            "bm25_similarity": float(bm25_sim[i, j]),
            "levenshtein_similarity": float(lev_sim[i, j]),
            "embedding_cosine_similarity": (
                float(embedding_sim[i, j]) if embedding_sim is not None else None
            ),
        }
        return rec

    original_vs = []
    for idx, rephrasing in enumerate(rephrasings):
        original_vs.append(
            {"rephrasing_index": idx, "rephrasing": rephrasing, **record(0, idx + 1)}
        )
    pairwise = []
    for i, j in combinations(range(len(rephrasings)), 2):
        pairwise.append(
            {
                "rephrasing_1_index": i,
                "rephrasing_2_index": j,
                **record(i + 1, j + 1),
            }
        )

    metrics = ["tfidf_cosine_similarity", "bm25_similarity", "levenshtein_similarity"]
    if embedding_sim is not None:
        metrics.insert(0, "embedding_cosine_similarity")
    summary = {}
    for metric in metrics:
        ov = [r[metric] for r in original_vs if r[metric] is not None]
        pw = [r[metric] for r in pairwise if r[metric] is not None]
        if not ov or not pw:
            continue
        summary[metric] = {
            "original_vs_rephrasings": _stats(ov),
            "pairwise_rephrasings": _stats(pw),
        }
    return {
        "original_vs_rephrasings": original_vs,
        "pairwise_rephrasings": pairwise,
        "summary_stats": summary,
    }


def _stats(values):
    return {
        "mean": float(np.mean(values)),
        "std": float(np.std(values)),
        "min": float(np.min(values)),
        "max": float(np.max(values)),
        "median": float(np.median(values)),
    }
