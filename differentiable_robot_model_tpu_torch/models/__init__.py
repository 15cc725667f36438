"""Robot description: RobotStruct, URDF ingest and the model API."""
