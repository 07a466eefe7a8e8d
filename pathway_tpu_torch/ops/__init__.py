"""Device ops of the port: the kernel wrappers, their plain versions, the KNN index."""
