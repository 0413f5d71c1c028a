from repro_torch.utils.ragged import ragged_row_offsets
