"""Pixel metrics with on-device confusion counting; port of the JAX
package's `losses/metrics.py`.

Parity with utils/metrics_DC.py:75-117: threshold 0.3, binary
precision/recall/F1 with sklearn's zero_division=1 convention,
specificity, the 2x2 confusion matrix and the annotated seaborn heatmap
artifact (`confusion_matrix_.png`). TP/FP/FN/TN are four int64 reductions
on the device; only the four numbers cross to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def confusion_counts(y_true: torch.Tensor, y_pred_probs: torch.Tensor,
                     thresh: float = 0.3,
                     sample_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """int64 counts [tn, fp, fn, tp]. `sample_mask` (B,) bool restricts the
    count to the samples it keeps."""
    yp = y_pred_probs > thresh
    yt = y_true > 0.5
    if sample_mask is not None:
        v = sample_mask.to(torch.bool).reshape(
            (-1,) + (1,) * (yp.dim() - 1))
        yp, yt = yp & v, yt & v
        tp = (yp & yt).sum()
        fp = (yp & ~yt & v).sum()
        fn = (~yp & yt & v).sum()
        tn = (~yp & ~yt & v).sum()
    else:
        tp = (yp & yt).sum()
        fp = (yp & ~yt).sum()
        fn = (~yp & yt).sum()
        tn = (~yp & ~yt).sum()
    return torch.stack([tn, fp, fn, tp]).to(torch.int64)


def pixel_metrics(counts) -> Tuple[float, float, float, float]:
    """(precision, recall, f1, specificity) from [tn, fp, fn, tp] with
    sklearn zero_division=1 semantics (utils/metrics_DC.py:79-84)."""
    if torch.is_tensor(counts):
        counts = counts.cpu().numpy()
    tn, fp, fn, tp = [float(c) for c in np.asarray(counts)]
    precision = tp / (tp + fp) if (tp + fp) > 0 else 1.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    specificity = tn / (tn + fp) if (tn + fp) > 0 else 0.0
    return precision, recall, f1, specificity


def calculate_metrics(y_true, y_pred_probs, thresh: float = 0.3):
    """utils/metrics_DC.py:75-85: (precision, recall, f1, specificity,
    2x2 int64 confusion matrix)."""
    counts = confusion_counts(torch.as_tensor(y_true),
                              torch.as_tensor(y_pred_probs),
                              thresh).cpu().numpy()
    precision, recall, f1, specificity = pixel_metrics(counts)
    tn, fp, fn, tp = counts
    cm = np.array([[tn, fp], [fn, tp]], dtype=np.int64)
    return precision, recall, f1, specificity, cm


def plot_binary_confusion_matrix_with_metrics(cm, accuracy,
                                              out_path="confusion_matrix_.png"):
    """Annotated 2x2 heatmap artifact (utils/metrics_DC.py:87-117): per-class
    Pr/Rec/Sp on the diagonal, overall accuracy in the title."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    tn, fp, fn, tp = np.asarray(cm).ravel()
    pr0 = tn / (tn + fn) if (tn + fn) > 0 else 0
    rec0 = tn / (tn + fp) if (tn + fp) > 0 else 0
    sp0 = tp / (tp + fp) if (tp + fp) > 0 else 0
    pr1 = tp / (tp + fp) if (tp + fp) > 0 else 0
    rec1 = tp / (tp + fn) if (tp + fn) > 0 else 0
    sp1 = tn / (tn + fn) if (tn + fn) > 0 else 0

    annot = np.empty((2, 2), dtype=object)
    annot[0, 0] = f"{tn}\nPr={pr0:.2f}\nRec={rec0:.2f}\nSp={sp0:.2f}"
    annot[0, 1] = f"{fp}"
    annot[1, 0] = f"{fn}"
    annot[1, 1] = f"{tp}\nPr={pr1:.2f}\nRec={rec1:.2f}\nSp={sp1:.2f}"

    plt.figure(figsize=(6, 5))
    sns.heatmap(np.asarray(cm), annot=annot, fmt="", cmap="Blues",
                xticklabels=["Negative", "Positive"],
                yticklabels=["Negative", "Positive"])
    plt.title(f"Overall Accuracy: {accuracy:.3f}")
    plt.xlabel("Predicted")
    plt.ylabel("Actual")
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
