"""Training: grad step, AdamW and the plan-ahead runner (sequential path)."""
