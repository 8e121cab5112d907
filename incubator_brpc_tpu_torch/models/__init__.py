"""Example service families (the framework's "models"): echo,
streaming echo, parameter server — analogs of reference example/*."""
