"""Evaluation suite: SalMetric (+E-measure, adaptive F/E), S-measure,
weighted F-measure, as batched tensor reductions on the card."""

from .salmetric import BETA2, EPSILON, THRESHOLDS, SalMetricAccumulator, format_report
from .smeasure import s_measure, s_measure_batch
from .wfmeasure import weighted_f_measure, weighted_f_measure_batch

__all__ = [
    "BETA2", "EPSILON", "THRESHOLDS", "SalMetricAccumulator",
    "format_report", "s_measure", "s_measure_batch",
    "weighted_f_measure", "weighted_f_measure_batch",
]
