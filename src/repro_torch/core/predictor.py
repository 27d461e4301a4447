"""Output-length predictor (§IV-B1).

Production traces carry length statistics but not prompt content, so —
exactly like the paper (§V, "we simulate an output predictor used in a prior
work, setting its accuracy to 85%") — the predictor is simulated at a
configurable accuracy: with prob `accuracy` it returns the true bucket,
otherwise a *uniformly chosen different* output class for the same input
class (S can mispredict as L: the paper specifies only the accuracy, not
an error taxonomy, and the uniform-error model is the adversarial choice —
an ordinal neighbor-biased model would understate the cost of
mispredictions for the decode load balancer).  The bucket taxonomy is
Table II's 3x3 input-output grid.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.velocity import BUCKETS, bucket_of


class OutputPredictor:
    def __init__(self, accuracy: float = 0.85, seed: int = 0):
        assert 0.0 <= accuracy <= 1.0
        self.accuracy = accuracy
        self.rng = np.random.RandomState(seed)
        self.n_total = 0
        self.n_correct = 0

    def predict_bucket(self, in_len: int, true_out_len: int) -> str:
        """Returns the predicted bucket for a request (input length is
        observable; the output class is what the model predicts)."""
        true = bucket_of(in_len, true_out_len)
        self.n_total += 1
        if self.rng.rand() < self.accuracy:
            self.n_correct += 1
            return true
        # mispredict: a different output class for the same input class
        i_cls, o_cls = true.split("-")
        wrong = [o for o in "SML" if o != o_cls]
        return f"{i_cls}-{self.rng.choice(wrong)}"

    def predict_out_len(self, in_len: int, true_out_len: int) -> int:
        from repro_torch.core.velocity import BUCKET_OUTPUT
        b = self.predict_bucket(in_len, true_out_len)
        return BUCKET_OUTPUT[b.split("-")[1]]

    @property
    def measured_accuracy(self) -> float:
        return self.n_correct / max(self.n_total, 1)
