"""The LM scaffolding of the port: decoder-only models (``model.py``) of
dense attention blocks on the prefill and flash-decode kernels, and of
xLSTM blocks (``recurrent.py``) on the sLSTM scan kernel."""
