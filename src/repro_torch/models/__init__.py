"""The LM scaffolding of the port: dense all-attention transformers
(``model.py``) on the prefill and flash-decode kernels."""
