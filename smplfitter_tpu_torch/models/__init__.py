"""Body model and fitter."""
