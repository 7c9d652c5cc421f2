"""The port's scenario-tree MPC, on one device (``scenario.py``)."""
