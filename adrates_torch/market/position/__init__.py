"""What the book compiler reads from the JAX package's single-trade
engine modules (``adrates_tpu/market/position``): CPI reference
classification and the credit instruments' leg tensors. The single-trade
engine itself is not ported yet."""
