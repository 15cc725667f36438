"""Functional ops on RobotStruct tensors: SO(3) helpers and kinematics."""
