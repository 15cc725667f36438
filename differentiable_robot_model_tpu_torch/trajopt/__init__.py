"""Kinematic trajectory optimization and MPC."""
