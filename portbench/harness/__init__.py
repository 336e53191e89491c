"""The benchmark's own code: the run (`runner`), loading the program
(`port`), the traced window and its spans (`trace`), the roofline
arithmetic (`roofline`) and the comparisons that decide `correct`
(`judge`)."""
