"""The plain reference that decides a run's ``correct``: float32 PyTorch,
independent of the program under test (see ``model.py``)."""
