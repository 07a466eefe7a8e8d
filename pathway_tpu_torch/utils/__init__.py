"""Host helpers of the engine."""
