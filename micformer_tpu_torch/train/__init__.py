"""The training harness: config, schedules, checkpoints, meters, the trainer."""
