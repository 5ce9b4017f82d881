"""The LM scaffolding of the port: the models (``model.py``: the training
loss, prefill and decode) of attention blocks on the prefill and
flash-decode kernels (training: ``attention.ring_attention``, plain
torch), with a dense or a Mixture-of-Experts FFN (``moe.py``), and of
recurrent blocks (``recurrent.py``: the sLSTM on its scan kernel;
training: its float32 step loop)."""
