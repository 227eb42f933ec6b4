"""The plain reference every cell's answers are held against.

Plain PyTorch in float64, written from the transforms' definitions: the
MODWT as circular convolutions with the dilated filters, its inverse as
the adjoints, the universal soft-threshold denoise, and the CWT as one
full-spectrum product per scale.  It imports nothing of the program and
takes nothing the program made: its filter taps are a frozen copy
(``filters.py``) and its Morlet spectrum is computed here.
"""
