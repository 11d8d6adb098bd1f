"""Beamforming: covariance estimation and the multichannel Wiener filters."""
