"""Host-side pipeline: experiment planning, plan-driven preprocessing, dataset
integrity checks, model selection, postprocessing and evaluation of
segmentations."""
