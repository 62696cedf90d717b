"""Launch layer of the port: the schedule-driven multi-job executor."""
