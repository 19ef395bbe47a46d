from . import geometry, oracle, beamform, freq, freq_equiv, kalman

__all__ = ["geometry", "oracle", "beamform", "freq", "freq_equiv", "kalman"]
