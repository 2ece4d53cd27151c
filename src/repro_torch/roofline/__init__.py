"""Roofline of the port: hardware constants (``hw``), the eager op-cost
walk (``op_cost``, the twin of ``repro.roofline.hlo_cost``) and the
three-term analysis (``analysis``)."""
