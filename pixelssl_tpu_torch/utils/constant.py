"""Task-type taxonomy (reference: pixelssl/utils/constant.py:1-2)."""

REGRESSION = 'regression'
CLASSIFICATION = 'classification'
