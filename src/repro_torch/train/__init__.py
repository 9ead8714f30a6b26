"""Training: AdamW, the synthetic LM data pipeline and the train step."""
