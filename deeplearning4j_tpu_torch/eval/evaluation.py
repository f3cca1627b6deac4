"""Evaluation accumulators (org/nd4j/evaluation).

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``: ``Evaluation``
(accuracy, precision, recall, F1, the confusion matrix), ``EvaluationBinary``,
``ROC`` / ``ROCBinary`` / ``ROCMultiClass`` (exact AUC and AUPRC),
``RegressionEvaluation`` and ``EvaluationCalibration``, with their masks.
Host numpy, as in the reference: the network's ``output`` runs on the
device, and the bookkeeping over its numpy result stays on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# numpy >= 2 names it trapezoid; older releases only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Evaluation:
    """Multiclass classification evaluation (Evaluation.java)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.label_names = list(labels) if labels else None
        self.confusion: Optional[np.ndarray] = None  # [actual, predicted]

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      dtype=np.int64)

    def eval(self, labels, predictions, mask=None) -> None:
        """Accumulate a batch. labels/predictions: one-hot/prob (N, C) or
        (N, T, C) with optional (N, T) mask — reference evalTimeSeries."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], dtype=bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        elif mask is not None:
            # per-example mask on (N, C) input — reference drops masked rows
            m = np.asarray(mask)
            if m.size != labels.shape[0]:
                raise ValueError(
                    f"per-output masks are not supported by Evaluation "
                    f"(mask shape {m.shape} vs {labels.shape[0]} examples); "
                    "use EvaluationBinary for per-output masking")
            m = m.astype(bool).reshape(-1)
            labels = labels[m]
            predictions = predictions[m]
        self._ensure(labels.shape[-1])
        actual = labels.argmax(-1)
        pred = predictions.argmax(-1)
        np.add.at(self.confusion, (actual, pred), 1)

    # ---- metrics ----------------------------------------------------------
    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def accuracy(self) -> float:
        c = self.confusion
        return float(np.diag(c).sum() / max(c.sum(), 1))

    def precision(self, cls: Optional[int] = None) -> float:
        c = self.confusion
        col = c.sum(axis=0).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            p = np.where(col > 0, self._tp() / col, np.nan)
        return float(p[cls]) if cls is not None else float(np.nanmean(p))

    def recall(self, cls: Optional[int] = None) -> float:
        c = self.confusion
        row = c.sum(axis=1).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.where(row > 0, self._tp() / row, np.nan)
        return float(r[cls]) if cls is not None else float(np.nanmean(r))

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 0.0 if p + r == 0 or np.isnan(p + r) else 2 * p * r / (p + r)

    def stats(self) -> str:
        n = self.num_classes or 0
        names = self.label_names or [str(i) for i in range(n)]
        lines = [
            "=" * 24 + "Evaluation Metrics" + "=" * 24,
            f" # of classes:    {n}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=" * 25 + "Confusion Matrix" + "=" * 25,
        ]
        header = "     " + " ".join(f"{names[j]:>5}" for j in range(n))
        lines.append(header)
        for i in range(n):
            lines.append(f"{names[i]:>4} " + " ".join(
                f"{self.confusion[i, j]:>5}" for j in range(n)))
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Distributed-eval combiner (IEvaluation.merge in the reference —
        what Spark RDD evaluation reduces with)."""
        if other.confusion is not None:
            self._ensure(other.confusion.shape[0])
            self.confusion += other.confusion
        return self


class EvaluationBinary:
    """EvaluationBinary.java: per-output independent binary eval at 0.5."""

    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels) > 0.5
        pred = np.asarray(predictions) > 0.5
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        flat_l = labels.reshape(-1, labels.shape[-1])
        flat_p = pred.reshape(-1, pred.shape[-1])
        if mask is not None:
            m = np.asarray(mask).astype(bool).reshape(-1)
            flat_l, flat_p = flat_l[m], flat_p[m]
        self.tp += (flat_l & flat_p).sum(0)
        self.fp += (~flat_l & flat_p).sum(0)
        self.tn += (~flat_l & ~flat_p).sum(0)
        self.fn += (flat_l & ~flat_p).sum(0)

    def accuracy(self):
        tot = self.tp + self.fp + self.tn + self.fn
        return float(((self.tp + self.tn) / np.maximum(tot, 1)).mean())

    def f1(self):
        p = self.tp / np.maximum(self.tp + self.fp, 1)
        r = self.tp / np.maximum(self.tp + self.fn, 1)
        f = np.where(p + r > 0, 2 * p * r / np.maximum(p + r, 1e-12), 0.0)
        return float(f.mean())


class ROC:
    """ROC.java in exact mode: full-resolution AUC / AUPRC for binary
    output."""

    def __init__(self):
        self.scores: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:  # two-column softmax
            labels = labels[..., 1]
            predictions = predictions[..., 1]
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            m = np.asarray(mask).astype(bool).reshape(-1)
            labels, predictions = labels[m], predictions[m]
        self.labels.append(labels)
        self.scores.append(predictions)

    def _sorted(self):
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        return y[order] > 0.5, s[order]

    def calculate_auc(self) -> float:
        y, _ = self._sorted()
        pos = y.sum()
        neg = len(y) - pos
        if pos == 0 or neg == 0:
            return float("nan")
        tpr = np.concatenate([[0], np.cumsum(y) / pos])
        fpr = np.concatenate([[0], np.cumsum(~y) / neg])
        return float(_trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        y, _ = self._sorted()
        pos = y.sum()
        if pos == 0:
            return float("nan")
        cum_tp = np.cumsum(y)
        precision = cum_tp / np.arange(1, len(y) + 1)
        recall = cum_tp / pos
        return float(_trapezoid(precision, recall))


class ROCBinary:
    """ROCBinary.java: an independent ROC per OUTPUT of a multi-label
    binary network (sigmoid outputs), unlike ROCMultiClass's one-vs-all
    over a softmax."""

    def __init__(self):
        self.per_output: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        orig_shape = labels.shape
        labels = labels.reshape(-1, labels.shape[-1])
        predictions = predictions.reshape(-1, labels.shape[-1])
        per_output_mask = None
        m = None
        if mask is not None:
            mk = np.asarray(mask)
            # per-output mask iff it matches the labels' FULL shape — a
            # last-dim-only match would misread a per-timestep (N, T) mask
            # whenever T == nOut
            if mk.shape == orig_shape:
                per_output_mask = mk.reshape(-1, labels.shape[-1])
            else:
                m = mk.reshape(-1)  # per-example/timestep mask, all outputs
        for c in range(labels.shape[-1]):
            mc = per_output_mask[:, c] if per_output_mask is not None else m
            self.per_output.setdefault(c, ROC()).eval(
                labels[:, c], predictions[:, c], mc)

    def calculate_auc(self, output: int) -> float:
        return self.per_output[output].calculate_auc()

    def calculate_auprc(self, output: int) -> float:
        return self.per_output[output].calculate_auprc()

    def calculate_average_auc(self) -> float:
        return float(np.nanmean(
            [r.calculate_auc() for r in self.per_output.values()]))


class ROCMultiClass:
    """ROCMultiClass.java: one-vs-all ROC per class."""

    def __init__(self):
        self.per_class: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        predictions = np.asarray(predictions).reshape(-1, labels.shape[-1])
        for c in range(labels.shape[-1]):
            self.per_class.setdefault(c, ROC()).eval(labels[:, c],
                                                     predictions[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.nanmean([r.calculate_auc()
                                 for r in self.per_class.values()]))


class RegressionEvaluation:
    """RegressionEvaluation.java: column-wise MSE/MAE/RMSE/R²/pearson."""

    def __init__(self):
        self.preds: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        l = np.asarray(labels).astype(np.float64)
        p = np.asarray(predictions).astype(np.float64)
        l = l.reshape(-1, l.shape[-1])
        p = p.reshape(-1, p.shape[-1])
        if mask is not None:
            m = np.asarray(mask).astype(bool).reshape(-1)
            l, p = l[m], p[m]
        self.labels.append(l)
        self.preds.append(p)

    def _cat(self):
        return np.concatenate(self.labels), np.concatenate(self.preds)

    def mean_squared_error(self, col: int = 0) -> float:
        l, p = self._cat()
        return float(((l[:, col] - p[:, col]) ** 2).mean())

    def mean_absolute_error(self, col: int = 0) -> float:
        l, p = self._cat()
        return float(np.abs(l[:, col] - p[:, col]).mean())

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        l, p = self._cat()
        ss_res = ((l[:, col] - p[:, col]) ** 2).sum()
        ss_tot = ((l[:, col] - l[:, col].mean()) ** 2).sum()
        return float(1 - ss_res / max(ss_tot, 1e-12))

    def pearson_correlation(self, col: int = 0) -> float:
        l, p = self._cat()
        return float(np.corrcoef(l[:, col], p[:, col])[0, 1])

    def average_mean_squared_error(self) -> float:
        l, p = self._cat()
        return float(((l - p) ** 2).mean())

    def stats(self) -> str:
        l, p = self._cat()
        n = l.shape[1]
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in range(n):
            lines.append(
                f"col_{c:<5} {self.mean_squared_error(c):<14.6f} "
                f"{self.mean_absolute_error(c):<14.6f} "
                f"{self.root_mean_squared_error(c):<14.6f} "
                f"{self.r_squared(c):<10.6f}"
            )
        return "\n".join(lines)


class EvaluationCalibration:
    """EvaluationCalibration.java: reliability diagram buckets."""

    def __init__(self, n_bins: int = 10):
        self.n_bins = n_bins
        self.bin_counts = np.zeros(n_bins, np.int64)
        self.bin_pos = np.zeros(n_bins, np.int64)
        self.bin_prob_sum = np.zeros(n_bins, np.float64)

    def eval(self, labels, predictions, mask=None) -> None:
        l = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        p = np.asarray(predictions).reshape(-1, l.shape[-1])
        if mask is not None:
            m = np.asarray(mask).astype(bool).reshape(-1)
            l, p = l[m], p[m]
        probs = p.reshape(-1)
        hits = l.reshape(-1) > 0.5
        bins = np.clip((probs * self.n_bins).astype(int), 0, self.n_bins - 1)
        np.add.at(self.bin_counts, bins, 1)
        np.add.at(self.bin_pos, bins, hits.astype(np.int64))
        np.add.at(self.bin_prob_sum, bins, probs)

    def reliability(self):
        """(mean predicted prob, empirical freq) per bin."""
        cnt = np.maximum(self.bin_counts, 1)
        return self.bin_prob_sum / cnt, self.bin_pos / cnt
