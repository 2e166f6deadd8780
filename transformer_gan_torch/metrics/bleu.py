"""BLEU / Self-BLEU over generated token sequences.

The port's own copy of ``transformer_gan_tpu/metrics/bleu.py`` (pure
Python, no framework), behaviour for behaviour, the subset draws from
Python's global ``random`` included.

Counterpart of reference model/utils/bleu.py (TextGAN lineage): per-
hypothesis sentence BLEU against the (shuffled, optionally sub-sampled)
real corpus, uniform n-gram weights, NLTK method-1 smoothing, sample_size
200, multiprocessing fan-out. The BLEU math is implemented here directly
(no nltk dependency): modified n-gram precision with per-reference clipping,
closest-length brevity penalty, and method1 smoothing (zero numerators
replaced by 0.1).
"""

from __future__ import annotations

import math
import random
from abc import abstractmethod
from collections import Counter


class Metrics:
    def __init__(self, name="Metric"):
        self.name = name

    def get_name(self):
        return self.name

    def set_name(self, name):
        self.name = name

    @abstractmethod
    def get_score(self):
        pass

    @abstractmethod
    def reset(self):
        pass


def _ngram_counts(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu(references, hypothesis, weights,
                  smoothing_eps: float = 0.1) -> float:
    """sentence_bleu with SmoothingFunction().method1 semantics."""
    hyp_len = len(hypothesis)
    if hyp_len == 0:
        return 0.0

    log_p_sum = 0.0
    for n, w in enumerate(weights, start=1):
        if w == 0:
            continue
        hyp_counts = _ngram_counts(hypothesis, n)
        total = max(sum(hyp_counts.values()), 1)
        max_ref = Counter()
        for ref in references:
            ref_counts = _ngram_counts(ref, n)
            for g, c in ref_counts.items():
                if g in hyp_counts and c > max_ref[g]:
                    max_ref[g] = c
        clipped = sum(min(c, max_ref[g]) for g, c in hyp_counts.items())
        if clipped == 0:
            clipped = smoothing_eps  # method1
        log_p_sum += w * math.log(clipped / total)

    # brevity penalty with closest reference length
    ref_len = min((abs(len(r) - hyp_len), len(r)) for r in references)[1]
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_p_sum)


def _cal_bleu(args):
    reference, hypothesis, weight = args
    return sentence_bleu(reference, hypothesis, weight)


class _RefProfile:
    """Per-reference-set precomputation for sentence BLEU.

    ``sentence_bleu`` recounts every reference's n-grams for every
    hypothesis — O(|refs| * |hyps|) Counter builds. The per-hypothesis
    clipping only ever consumes max_ref[g] = max over references of that
    reference's count of gram g, which is a property of the reference set
    alone; computing it once turns the metric from minutes of host time
    per eval (self-BLEU: 512 refs x 512 tokens x 200 hyps) into seconds,
    bit-identically (``tests/test_torch_metrics.py`` asserts equality
    with the naive oracle)."""

    def __init__(self, references, max_n):
        self.lengths = [len(r) for r in references]
        self.max_counts = {}
        for n in range(1, max_n + 1):
            mc = Counter()
            for ref in references:
                for g, c in _ngram_counts(ref, n).items():
                    if c > mc[g]:
                        mc[g] = c
            self.max_counts[n] = mc

    def sentence_bleu(self, hypothesis, weights,
                      smoothing_eps: float = 0.1) -> float:
        hyp_len = len(hypothesis)
        if hyp_len == 0:
            return 0.0
        log_p_sum = 0.0
        for n, w in enumerate(weights, start=1):
            if w == 0:
                continue
            hyp_counts = _ngram_counts(hypothesis, n)
            total = max(sum(hyp_counts.values()), 1)
            mc = self.max_counts[n]
            clipped = sum(min(c, mc[g]) for g, c in hyp_counts.items())
            if clipped == 0:
                clipped = smoothing_eps  # method1
            log_p_sum += w * math.log(clipped / total)
        ref_len = min((abs(rl - hyp_len), rl) for rl in self.lengths)[1]
        bp = (1.0 if hyp_len > ref_len
              else math.exp(1 - ref_len / max(hyp_len, 1)))
        return bp * math.exp(log_p_sum)


class BLEU(Metrics):
    """API-compatible with the reference BLEU metric (bleu.py:64-155)."""

    def __init__(self, name=None, test_text=None, real_text=None, gram=3,
                 portion=1, if_use=False):
        assert isinstance(gram, (int, list)), "Gram format error!"
        super().__init__("%s-%s" % (name, gram))
        self.if_use = if_use
        self.test_text = test_text
        self.real_text = real_text
        self.gram = [gram] if isinstance(gram, int) else gram
        self.sample_size = 200
        self.reference = None
        self.is_first = True
        self.portion = portion

    def reset(self, test_text=None, real_text=None):
        self.test_text = test_text
        self.real_text = real_text

    def get_reference(self):
        reference = list(self.real_text)
        random.shuffle(reference)
        return reference[:int(self.portion * len(reference))]

    def get_score(self, is_fast=True, given_gram=None):
        if not self.if_use:
            return 0
        if self.is_first:
            self.reference = self.get_reference()
            self.is_first = False
        grams = [given_gram] if given_gram is not None else self.gram
        all_bleu = []
        # The _RefProfile precomputation replaces both reference paths
        # (it is faster than the multiprocessing fan-out and exact — no
        # fork() under a multithreaded host), but the SUBSET-drawing
        # semantics track the reference (bleu.py:107-145): is_fast
        # (get_bleu_fast) draws ONE shuffled subset shared by every
        # gram; the slow path (get_bleu) redraws a fresh subset per
        # gram. The two only differ for portion < 1 — at portion 1 the
        # subset is the whole corpus either way.
        shared_profile = None
        if is_fast:
            shared_reference = self.get_reference()
        for ngram in grams:
            weight = tuple(1.0 / ngram for _ in range(ngram))
            if is_fast:
                if shared_profile is None:
                    shared_profile = _RefProfile(shared_reference,
                                                 max(grams))
                profile = shared_profile
            else:
                profile = _RefProfile(self.get_reference(), ngram)
            scores = [profile.sentence_bleu(hyp, weight)
                      for hyp in self.test_text[:self.sample_size]]
            all_bleu.append(round(sum(scores) / max(len(scores), 1), 3))
        return all_bleu[0] if given_gram is not None else all_bleu
