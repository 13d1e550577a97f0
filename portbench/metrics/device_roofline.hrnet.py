from portbench.readers import device_roofline as read  # noqa: F401
