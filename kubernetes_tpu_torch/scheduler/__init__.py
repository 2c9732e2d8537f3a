"""The port's ScheduleAlgorithm (algorithm.TorchScheduleAlgorithm)."""
