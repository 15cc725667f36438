"""Trajectory optimization and MPC: rollouts, costs and Adam solvers, kinematic and torque-space."""
