"""Host-side postprocessing and evaluation of segmentations."""
