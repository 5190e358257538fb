"""Loss and metric engine of the port."""
