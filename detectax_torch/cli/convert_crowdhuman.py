from detectax_torch.data.convert_crowdhuman import main  # noqa: F401

if __name__ == "__main__":
    main()
