"""The LM scaffolding of the port: the models (``model.py``) of attention
blocks on the prefill and flash-decode kernels, with a dense or a
Mixture-of-Experts FFN (``moe.py``), and of recurrent blocks
(``recurrent.py``: the sLSTM on its scan kernel)."""
