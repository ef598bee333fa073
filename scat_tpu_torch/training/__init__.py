"""Training: optimizer schedule, train state, train and eval steps, trainer."""
