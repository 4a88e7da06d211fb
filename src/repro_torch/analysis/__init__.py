"""Cost analysis of the port's steps (port of :mod:`repro.analysis`):
``op_cost`` counts a step's aten ops (the counterpart of the
reference's ``hlo_cost``, which reads XLA's HLO text) and ``roofline``
turns the count into the H100's compute, memory and collective times.
"""
