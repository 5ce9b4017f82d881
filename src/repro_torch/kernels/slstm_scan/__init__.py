"""The sLSTM recurrence: the scan kernel (``ops.py``) and its plain
version (``ref.py``)."""
