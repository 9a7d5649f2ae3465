"""Drivers, one a traffic kind: set-up, the measured window (closed loop),
the traced slice and the sample of finished work the reference checks."""
