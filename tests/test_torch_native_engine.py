from torch_carry import carry

carry(globals(), "test_native_engine")
