"""One module per traffic kind; a traffic file names its driver."""
