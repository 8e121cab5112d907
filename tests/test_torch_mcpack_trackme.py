from torch_carry import carry

carry(globals(), "test_mcpack_trackme")
